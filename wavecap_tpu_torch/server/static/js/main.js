// App shell: sidebar nav + hash router over the view modules, global
// health status bar, and frontend error shipping (reference
// ErrorStatusBar.react.tsx + POST /frontend-logs).

import { api } from "./api.js";
import { el, clear } from "./ui.js";
import { getState, subscribe, connectStateWs, refreshAll } from "./store.js";
import { mountMonitor } from "./views/monitor.js";
import { mountTrunking } from "./views/trunking.js";
import { mountScanner } from "./views/scanner.js";
import { mountMessages } from "./views/messages.js";
import { mountRecipes } from "./views/recipes.js";
import { mountDevices } from "./views/devices.js";
import { mountSystem } from "./views/system.js";

const VIEWS = {
  monitor: { label: "Monitor", icon: "📡", mount: mountMonitor },
  trunking: { label: "Trunking", icon: "🗼", mount: mountTrunking },
  scanner: { label: "Scanner", icon: "🔁", mount: mountScanner },
  messages: { label: "Messages", icon: "✉", mount: mountMessages },
  recipes: { label: "Recipes", icon: "📻", mount: mountRecipes },
  devices: { label: "Devices", icon: "🔌", mount: mountDevices },
  system: { label: "System", icon: "🖥", mount: mountSystem },
};

let unmount = null;
let navEl = null;
let contentEl = null;

function currentView() {
  const h = location.hash.replace(/^#\//, "");
  return VIEWS[h] ? h : "monitor";
}

function renderNav() {
  const active = currentView();
  const conn = getState().connected;
  clear(navEl);
  navEl.append(
    el("div", { class: "brand" }, "WaveCap", el("small", {}, "TPU SDR console")),
    ...Object.entries(VIEWS).map(([key, v]) =>
      el("a", { href: `#/${key}`, class: key === active ? "active" : "" },
        el("span", {}, v.icon), v.label)),
    el("div", { class: "conn" },
      el("span", { class: `dot ${conn ? "ok" : ""}` }),
      conn ? "connected" : "disconnected"));
}

// view-level error boundary (reference ErrorBoundary.react.tsx): a
// throwing view renders a fallback panel instead of blanking the app,
// ships the error, and offers reload/retry.
function errorFallback(view, err) {
  clear(contentEl);
  contentEl.append(
    el("div", { class: "panel error-boundary" },
      el("h2", {}, "Something went wrong"),
      el("p", {}, `The ${view} view crashed: `,
        el("code", {}, String(err?.message || err))),
      el("pre", { class: "muted" }, String(err?.stack || "").split("\n").slice(0, 6).join("\n")),
      el("div", { style: "display:flex; gap:8px" },
        el("button", { class: "primary", onClick: route }, "Retry view"),
        el("button", { onClick: () => location.reload() }, "Reload app"))));
  shipError(`view ${view} crashed: ${err?.message || err}`, "error-boundary");
}

function route() {
  try { unmount?.(); } catch { /* old view teardown must not block routing */ }
  unmount = null;
  clear(contentEl);
  renderNav();
  const view = currentView();
  try {
    unmount = VIEWS[view].mount(contentEl);
  } catch (err) {
    errorFallback(view, err);
  }
}

// ---------------------------------------------------------------------------
// global status bar: unhealthy captures / failed systems / error rates
// ---------------------------------------------------------------------------

let statusEl = null;

function renderStatusBar() {
  if (!statusEl) return;
  const s = getState();
  const problems = [];
  for (const c of s.captures) {
    if (c.state === "failed")
      problems.push(`capture ${c.id} failed${c.error ? `: ${c.error}` : ""}`);
  }
  for (const t of s.trunking) {
    if (t.state === "failed")
      problems.push(`system ${t.id} failed${t.error ? `: ${t.error}` : ""}`);
  }
  if (!s.connected) problems.push("server connection lost — reconnecting");
  clear(statusEl);
  if (!problems.length) {
    statusEl.style.display = "none";
    return;
  }
  statusEl.style.display = "flex";
  statusEl.append(
    el("span", { class: "dot err" }),
    el("span", {}, problems.join(" · ")));
}

// ship uncaught SPA errors to the server's frontend-log store
function shipError(message, source) {
  try {
    api.post("/frontend-logs", [{ level: "error", message, source }])
      .catch(() => {});
  } catch { /* never recurse */ }
}

window.addEventListener("error", (e) =>
  shipError(`${e.message} @ ${e.filename}:${e.lineno}`, "window.onerror"));
window.addEventListener("unhandledrejection", (e) =>
  shipError(String(e.reason), "unhandledrejection"));

function boot() {
  const app = document.getElementById("app");
  navEl = el("nav", { class: "side" });
  statusEl = el("div", { class: "status-bar" });
  contentEl = el("main", { class: "content" });
  const right = el("div", { class: "main-col" }, statusEl, contentEl);
  app.append(navEl, right);
  subscribe((what) => {
    if (what === "conn") renderNav();
    renderStatusBar();
  });
  connectStateWs();
  refreshAll();
  window.addEventListener("hashchange", route);
  route();
  renderStatusBar();
}

boot();
