// Messages view: decoded POCSAG / FLEX / RDS traffic across all channels.

import { api } from "../api.js";
import { el, clear, fmtTime } from "../ui.js";
import { getState } from "../store.js";

let rootEl = null;
let timer = null;
let rows = [];
let filter = "all";
let lastTop = 0;  // newest message time at last render (fresh-row flash)

async function fetchAll() {
  const caps = getState().captures;
  const chans = caps.flatMap((c) => c.channels || []);
  const out = [];
  await Promise.allSettled(chans.map(async (ch) => {
    try {
      const msgs = await api.get(`/channels/${ch.id}/messages?limit=100`);
      for (const m of msgs) out.push({ channel: ch.name || ch.id, ...m });
    } catch { /* channel may be gone */ }
  }));
  out.sort((a, b) => (b.time || 0) - (a.time || 0));
  rows = out.slice(0, 300);
  render();
  lastTop = rows.length ? rows[0].time || 0 : lastTop;
}

// Compact one-line live feed of the newest decoded message (reference
// POCSAGFeed ticker); polls independently so any view can embed it.
export function messageTicker() {
  const node = el("div", { class: "ticker" }, "");
  let t = null;
  const tick = async () => {
    if (!node.isConnected) { clearInterval(t); return; }
    const caps = getState().captures;
    const chans = caps.flatMap((c) => c.channels || []);
    let newest = null;
    await Promise.allSettled(chans.map(async (ch) => {
      try {
        const msgs = await api.get(`/channels/${ch.id}/messages?limit=1`);
        for (const m of msgs)
          if (!newest || (m.time || 0) > (newest.time || 0))
            newest = { channel: ch.name || ch.id, ...m };
      } catch { /* channel may be gone */ }
    }));
    clear(node);
    if (newest) {
      node.append(
        el("span", { class: "muted" }, `${fmtTime(newest.time)} `),
        el("span", {}, `${newest.decoder} `),
        el("span", { class: "mono" },
          `${newest.alias || newest.address || newest.capcode || ""} ${
            newest.text || newest.message || newest.radiotext || ""}`.trim()));
    }
  };
  t = setInterval(tick, 5000);
  tick();
  return node;
}

function render() {
  if (!rootEl) return;
  const kinds = ["all", ...new Set(rows.map((r) => r.decoder))];
  const shown = filter === "all" ? rows : rows.filter((r) => r.decoder === filter);
  clear(rootEl);
  rootEl.append(
    el("div", { class: "toolbar" },
      el("h1", { style: "margin:0" }, "Messages"),
      el("span", { class: "right" }),
      el("select", { onChange: (e) => { filter = e.target.value; render(); } },
        ...kinds.map((k) =>
          el("option", { value: k, selected: k === filter }, k)))),
    el("div", { class: "panel" },
      shown.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Time"), el("th", {}, "Channel"),
              el("th", {}, "Decoder"), el("th", {}, "Address"),
              el("th", {}, "Message"))),
            el("tbody", {}, shown.map((m) => el("tr", {
              class: `msg-row ${(m.time || 0) > lastTop ? "fresh" : ""}`,
            },
              el("td", {}, fmtTime(m.time)),
              el("td", {}, m.channel),
              el("td", {}, m.decoder),
              el("td", { class: "mono" },
                m.alias || m.address || m.capcode || m.station || "—"),
              el("td", { class: "mono", style: "max-width:480px; overflow-wrap:anywhere" },
                m.text || m.message || m.radiotext || JSON.stringify(m))))))
        : el("div", { class: "empty" },
            "No decoded messages yet. Enable POCSAG / FLEX / RDS attachments on a channel.")));
}

export function mountMessages(container) {
  rootEl = container;
  fetchAll();
  timer = setInterval(fetchAll, 4000);
  render();
  return () => { clearInterval(timer); timer = null; rootEl = null; };
}
