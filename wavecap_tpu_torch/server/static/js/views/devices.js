// Devices view: SDR inventory, nicknames, driver health + recovery actions.

import { api } from "../api.js";
import { el, clear, toast, modal, confirmDlg, badge , statusPill } from "../ui.js";
import { getState, subscribe, refreshDevices } from "../store.js";

let rootEl = null;
let unsub = null;
let health = null;
let timer = null;

async function nicknameDlg(d) {
  const vals = await modal({
    title: `Nickname — ${d.label || d.id}`,
    fields: [{ name: "nickname", label: "Nickname", value: d.nickname || "" }],
    submitLabel: "Save",
  });
  if (!vals) return;
  try {
    await api.put(`/devices/${d.id}/nickname`, { nickname: vals.nickname });
    toast("Saved");
    refreshDevices();
  } catch (e) { toast(e.message, true); }
}

async function fetchHealth() {
  try { health = await api.get("/devices/health"); } catch { health = null; }
  render();
}

function render() {
  if (!rootEl) return;
  const devices = getState().devices;
  clear(rootEl);
  rootEl.append(
    el("h1", {}, "Devices"),
    el("div", { class: "panel" },
      el("h2", {}, "SDR inventory"),
      devices.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Id"), el("th", {}, "Driver"), el("th", {}, "Label"),
              el("th", {}, "Serial"), el("th", {}, "Nickname"), el("th", {}, ""))),
            el("tbody", {}, devices.map((d) => el("tr", {},
              el("td", { class: "mono" }, d.id),
              el("td", {}, d.driver),
              el("td", {}, d.label || "—"),
              el("td", { class: "mono" }, d.serial || "—"),
              el("td", {}, d.nickname || el("span", { class: "muted" }, "—")),
              el("td", {}, el("button", { class: "small",
                onClick: () => nicknameDlg(d) }, "Rename"))))))
        : el("div", { class: "empty" }, "No devices detected")),
    el("div", { class: "row" },
      el("div", { class: "panel" },
        el("h2", {}, "Capture health"),
        health?.captures?.length
          ? el("table", {},
              el("thead", {}, el("tr", {},
                el("th", {}, "Capture"), el("th", {}, "State"),
                el("th", { class: "num" }, "Restarts"),
                el("th", { class: "num" }, "Overflows"),
                el("th", { class: "num" }, "Last block (s)"))),
              el("tbody", {}, health.captures.map((c) => el("tr", {},
                el("td", { class: "mono" }, c.id),
                el("td", {}, statusPill(c.state), c.error
                  ? el("span", { class: "muted", style: "margin-left:6px" }, c.error)
                  : null),
                el("td", { class: "num" }, c.restartCount ?? 0),
                el("td", { class: "num" }, c.overflowCount ?? 0),
                el("td", { class: "num" }, c.lastBlockAge ?? "—")))))
          : el("div", { class: "empty" }, "No active captures")),
      el("div", { class: "panel" },
        el("h2", {}, "Driver recovery"),
        el("div", { class: "mono sec", style: "font-size:12px; margin-bottom:10px" },
          health?.recovery ? JSON.stringify(health.recovery, null, 1) : "—"),
        el("div", { style: "display:flex; gap:8px" },
          el("button", { onClick: async () => {
            if (!(await confirmDlg("Restart the SDR driver service?"))) return;
            try {
              const out = await api.post("/devices/service/restart");
              toast(out.ok ? "Service restarted" : `Denied: ${out.reason}`);
            } catch (e) { toast(e.message, true); }
            fetchHealth();
          } }, "Restart driver service"),
          el("button", {
            disabled: !health?.usbPowerCycle?.available,
            onClick: async () => {
              if (!(await confirmDlg("Power-cycle the USB port?"))) return;
              try {
                const out = await api.post("/devices/usb/power-cycle", {});
                toast(out.ok ? "Power-cycled" : `Failed: ${out.reason || ""}`);
              } catch (e) { toast(e.message, true); }
            } }, "USB power-cycle")))));
}

export function mountDevices(container) {
  rootEl = container;
  unsub?.();
  unsub = subscribe((what) => { if (what === "devices") render(); });
  fetchHealth();
  timer = setInterval(fetchHealth, 5000);
  render();
  return () => {
    unsub?.(); unsub = null;
    clearInterval(timer); timer = null;
    rootEl = null;
  };
}
