// Scanner view: frequency-list scanning on an existing channel.

import { api } from "../api.js";
import { el, clear, fmtHz, badge, toast, modal, confirmDlg , statusPill } from "../ui.js";
import { getState, subscribe, refreshScanners } from "../store.js";

let rootEl = null;
let unsub = null;
let timer = null;

async function createScannerDlg() {
  const caps = getState().captures;
  const chans = caps.flatMap((c) =>
    (c.channels || []).map((ch) => ({ cap: c, ch })));
  if (!chans.length) {
    toast("Create a capture with a channel first", true);
    return;
  }
  const vals = await modal({
    title: "New scanner",
    fields: [
      { name: "chan", label: "Channel to drive", type: "select",
        options: chans.map(({ cap, ch }) => ({
          value: `${cap.id}:${ch.id}`,
          label: `${cap.id} / ${ch.name || ch.id} (${ch.mode})`,
        })) },
      { name: "list", label: "Frequencies (MHz, comma-separated)",
        value: "155.0, 155.1, 155.2" },
      { name: "mode", label: "Mode", type: "select", value: "sequential",
        options: [{ value: "sequential" }, { value: "priority" }] },
      { name: "dwellS", label: "Dwell (s)", type: "number", value: 0.5, step: "0.1" },
      { name: "holdS", label: "Hold on activity (s)", type: "number", value: 2, step: "0.5" },
      { name: "squelchDb", label: "Squelch (dBFS)", type: "number", value: -60 },
    ],
  });
  if (!vals) return;
  const [captureId, channelId] = vals.chan.split(":");
  const entries = vals.list.split(",")
    .map((s) => Number(s.trim()) * 1e6)
    .filter((v) => isFinite(v) && v > 0)
    .map((frequencyHz) => ({ frequencyHz }));
  try {
    await api.post("/scanners", {
      captureId, channelId, entries,
      mode: vals.mode, dwellS: vals.dwellS, holdS: vals.holdS,
      squelchDb: vals.squelchDb,
    });
    toast("Scanner created");
    refreshScanners();
  } catch (e) { toast(e.message, true); }
}

function scannerPanel(s) {
  return el("div", { class: "panel" },
    el("h2", {},
      `Scanner ${s.id}`, statusPill(s.state),
      el("span", { class: "muted mono" },
        s.currentFrequencyHz ? `now ${fmtHz(s.currentFrequencyHz)}` : ""),
      el("span", { class: "spacer" }),
      s.state === "stopped"
        ? el("button", { class: "small primary", onClick: () =>
            api.post(`/scanners/${s.id}/start`).then(refreshScanners) }, "Start")
        : el("button", { class: "small", onClick: () =>
            api.post(`/scanners/${s.id}/stop`).then(refreshScanners) }, "Stop"),
      s.state === "paused" || s.state === "locked"
        ? el("button", { class: "small primary", title: "resume scanning",
            onClick: () =>
              api.post(`/scanners/${s.id}/resume`).then(refreshScanners) },
            "▶ Resume")
        : el("button", { class: "small", title: "stay on the current frequency",
            disabled: s.state === "stopped",
            onClick: () =>
              api.post(`/scanners/${s.id}/pause`).then(refreshScanners) },
            "⏸ Pause"),
      el("button", { class: "small",
        title: "hold the current channel while listening",
        disabled: s.state === "stopped" || s.state === "locked",
        onClick: () =>
          api.post(`/scanners/${s.id}/lock`).then(refreshScanners) },
        "Hold"),
      el("button", { class: "small", title: "edit dwell/hold/squelch/mode",
        onClick: async () => {
          const vals = await modal({
            title: `Scanner ${s.id} settings`,
            fields: [
              { name: "mode", label: "Mode", type: "select", value: s.mode,
                options: [{ value: "sequential" }, { value: "priority" },
                          { value: "activity" }] },
              { name: "dwellS", label: "Dwell (s)", type: "number",
                value: s.dwellS ?? 0.5, step: "0.1" },
              { name: "holdS", label: "Hold (s)", type: "number",
                value: s.holdS ?? 2, step: "0.5" },
              { name: "squelchDb", label: "Squelch (dBFS)", type: "number",
                value: s.squelchDb ?? -60 },
            ],
            submitLabel: "Save",
          });
          if (!vals) return;
          api.patch(`/scanners/${s.id}`, vals).then(refreshScanners)
            .catch((e) => toast(e.message, true));
        } }, "⚙"),
      el("button", { class: "small", title: "clear all lockouts",
        onClick: () =>
          api.del(`/scanners/${s.id}/lockouts`).then(refreshScanners)
            .catch((e) => toast(e.message, true)) }, "Clear lockouts"),
      el("button", { class: "small danger", onClick: async () => {
        if (!(await confirmDlg(`Delete scanner ${s.id}?`))) return;
        await api.del(`/scanners/${s.id}`).catch((e) => toast(e.message, true));
        refreshScanners();
      } }, "✕")),
    el("table", {},
      el("thead", {}, el("tr", {},
        el("th", {}, "Frequency"), el("th", {}, "Name"),
        el("th", { class: "num" }, "Hits"), el("th", {}, "Lockout"))),
      el("tbody", {}, (s.entries || []).map((e) => el("tr", {
        style: e.frequencyHz === s.currentFrequencyHz
          ? "outline:1px solid var(--accent)" : "",
      },
        el("td", { class: "mono" }, fmtHz(e.frequencyHz)),
        el("td", {}, e.name || "—"),
        el("td", { class: "num" }, e.hits),
        el("td", {},
          el("button", { class: "small", onClick: () =>
            api.post(`/scanners/${s.id}/lockout`, {
              frequencyHz: e.frequencyHz, locked: !e.lockedOut,
            }).then(refreshScanners) },
            e.lockedOut ? "Unlock" : "Lock out")))))));
}

function render() {
  if (!rootEl) return;
  const scanners = getState().scanners;
  clear(rootEl);
  rootEl.append(
    el("div", { class: "toolbar" },
      el("h1", { style: "margin:0" }, "Scanner"),
      el("span", { class: "right" }),
      el("button", { class: "primary", onClick: createScannerDlg }, "+ New scanner")),
    scanners.length
      ? el("div", {}, scanners.map(scannerPanel))
      : el("div", { class: "empty" }, "No scanners configured."));
}

export function mountScanner(container) {
  rootEl = container;
  unsub?.();
  unsub = subscribe((what) => { if (what === "scanners") render(); });
  timer = setInterval(() => refreshScanners().catch(() => {}), 2000);
  render();
  return () => {
    unsub?.(); unsub = null;
    clearInterval(timer); timer = null;
    rootEl = null;
  };
}
