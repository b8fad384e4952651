// System view: metrics tiles + sparkline history, live log tail, recent
// errors, frontend-log store, config dump.

import { api, openWs } from "../api.js";
import { el, clear, fmtDur, toast } from "../ui.js";

let rootEl = null;
let metrics = null;
let errors = null;
let timer = null;
let logsWs = null;
const logLines = [];
// rolling metric history (kept across tab switches; ~10 min at 5 s polls)
const history = { cpu: [], mem: [], blockMs: [], errRate: [] };

function pushHist(key, v) {
  if (v === null || v === undefined || !isFinite(v)) return;
  const h = history[key];
  h.push(v);
  if (h.length > 120) h.splice(0, h.length - 120);
}

let feLogs = [];

async function fetchAll() {
  try { metrics = await api.get("/system/metrics"); } catch { metrics = null; }
  try { errors = await api.get("/errors"); } catch { errors = null; }
  try { feLogs = await api.get("/frontend-logs?limit=60"); } catch { feLogs = []; }
  if (metrics) {
    pushHist("cpu", metrics.cpuPercent);
    pushHist("mem", metrics.memory?.percent);
    const caps = Object.values(metrics.captures || {});
    if (caps.length)
      pushHist("blockMs", Math.max(...caps.map((c) => c.blockMs || 0)));
    const rates = Object.values(metrics.errorRates || {});
    // errorRates values are {rate1s, rate1m, total}; rate1m is events/sec
    pushHist("errRate",
      rates.reduce((s, v) => s + (v.rate1m ?? 0) * 60, 0));
  }
  render();
}

function tile(v, k) {
  return el("div", { class: "tile" },
    el("div", { class: "v" }, v), el("div", { class: "k" }, k));
}

function spark(key, label, value, unit) {
  const cv = el("canvas", { width: 220, height: 36 });
  const data = history[key];
  const ctx = cv.getContext("2d");
  ctx.clearRect(0, 0, cv.width, cv.height);
  if (data.length > 1) {
    const lo = Math.min(...data), hi = Math.max(...data);
    const span = Math.max(hi - lo, 1e-9);
    ctx.strokeStyle = "#3987e5";
    ctx.lineWidth = 1.5;
    ctx.beginPath();
    data.forEach((v, i) => {
      const x = (i / (data.length - 1)) * cv.width;
      const y = cv.height - 3 - ((v - lo) / span) * (cv.height - 8);
      if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
    });
    ctx.stroke();
  }
  return el("div", { class: "spark" },
    el("div", { class: "k" }, label),
    el("div", { class: "v" },
      value === null || value === undefined ? "—"
        : `${typeof value === "number" ? value.toFixed(1) : value}${unit || ""}`),
    cv);
}

function render() {
  if (!rootEl) return;
  clear(rootEl);
  const m = metrics || {};
  const capEntries = Object.entries(m.captures || {});
  rootEl.append(
    el("h1", {}, "System"),
    el("div", { class: "tiles" },
      tile(fmtDur(m.uptimeS), "Uptime"),
      tile(capEntries.length, "Captures"),
      tile(capEntries.reduce((s, [, c]) => s + (c.blocksProcessed || 0), 0),
        "Blocks processed")),
    el("div", { class: "spark-grid", style: "margin-bottom:14px" },
      spark("cpu", "CPU", m.cpuPercent, "%"),
      spark("mem", "Memory", m.memory?.percent, "%"),
      spark("blockMs", "Slowest capture block",
        history.blockMs[history.blockMs.length - 1], " ms"),
      spark("errRate", "Errors / min",
        history.errRate[history.errRate.length - 1], "")),
    el("div", { class: "row" },
      el("div", { class: "panel" },
        el("h2", {}, "Live log",
          el("span", { class: "spacer" }),
          el("button", { class: "small", onClick: () => {
            logLines.length = 0;
            render();
          } }, "Clear")),
        el("div", { class: "logbox", id: "sys-logs" },
          logLines.slice(-400).join("\n"))),
      el("div", { class: "panel" },
        el("h2", {}, "Recent errors"),
        errors && (errors.recent?.length || errors.length)
          ? el("div", { class: "logbox" },
              JSON.stringify(errors, null, 1))
          : el("div", { class: "empty" }, "No errors recorded"),
        el("h2", { style: "margin-top:12px" }, "Frontend logs",
          el("span", { class: "spacer" }),
          el("button", { class: "small", onClick: () =>
            api.del("/frontend-logs").then(() => { feLogs = []; render(); })
              .catch((e) => toast(e.message, true)) }, "Clear")),
        feLogs.length
          ? el("div", { class: "logbox", style: "max-height:120px" },
              feLogs.slice(-60).map((l) =>
                `${l.level}  ${l.source}  ${l.message}`).join("\n"))
          : el("div", { class: "empty" }, "No client-side errors shipped"),
        el("h2", { style: "margin-top:12px" }, "Maintenance"),
        el("div", { style: "display:flex; gap:8px" },
          el("button", { onClick: () =>
            api.post("/config/reload").then(() => toast("Config reloaded"))
              .catch((e) => toast(e.message, true)) }, "Reload config"),
          el("button", { onClick: async () => {
            try {
              const cfg = await api.get("/config");
              const w = window.open("", "_blank");
              w.document.write("<pre>" +
                JSON.stringify(cfg, null, 2).replace(/</g, "&lt;") + "</pre>");
            } catch (e) { toast(e.message, true); }
          } }, "View config")))));
}

export function mountSystem(container) {
  rootEl = container;
  fetchAll();
  timer = setInterval(fetchAll, 5000);
  if (!logsWs) {
    logsWs = openWs("/stream/logs", {
      json: (rec) => {
        const lvl = (rec.level || "").toLowerCase();
        const line = `${rec.time ?? ""} ${rec.level ?? ""} ${rec.logger ?? ""}  ${rec.message ?? JSON.stringify(rec)}`;
        logLines.push(line);
        if (logLines.length > 800) logLines.splice(0, 200);
        const box = document.getElementById("sys-logs");
        if (box) {
          box.textContent = logLines.slice(-400).join("\n");
          box.scrollTop = box.scrollHeight;
        }
      },
    });
  }
  render();
  return () => {
    clearInterval(timer); timer = null;
    rootEl = null;
    // keep the log WS alive so history accumulates
  };
}
