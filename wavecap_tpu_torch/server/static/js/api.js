// REST + WebSocket helpers for the WaveCap TPU API (/api/v1).

const BASE = "/api/v1";

async function req(method, path, body) {
  const opts = { method, headers: {} };
  if (body !== undefined) {
    opts.headers["Content-Type"] = "application/json";
    opts.body = JSON.stringify(body);
  }
  const key = localStorage.getItem("apiKey");
  if (key) opts.headers["x-api-key"] = key;
  const resp = await fetch(BASE + path, opts);
  const text = await resp.text();
  let data = null;
  try { data = text ? JSON.parse(text) : null; } catch { data = text; }
  if (!resp.ok) {
    const msg = (data && data.error) || `${resp.status} ${resp.statusText}`;
    const err = new Error(msg);
    err.status = resp.status;
    throw err;
  }
  return data;
}

export const api = {
  get: (p) => req("GET", p),
  post: (p, b) => req("POST", p, b ?? {}),
  patch: (p, b) => req("PATCH", p, b),
  put: (p, b) => req("PUT", p, b),
  del: (p) => req("DELETE", p),
};

export function wsUrl(path) {
  const proto = location.protocol === "https:" ? "wss:" : "ws:";
  return `${proto}//${location.host}${BASE}${path}`;
}

// Reconnecting WebSocket. handlers: {json(obj), binary(ArrayBuffer), open(), close()}
export function openWs(path, handlers = {}) {
  let ws = null;
  let closed = false;
  let retry = 500;

  function connect() {
    if (closed) return;
    ws = new WebSocket(wsUrl(path));
    ws.binaryType = "arraybuffer";
    ws.onopen = () => {
      retry = 500;
      handlers.open?.();
    };
    ws.onmessage = (ev) => {
      if (typeof ev.data === "string") {
        try { handlers.json?.(JSON.parse(ev.data)); } catch { /* ignore */ }
      } else {
        handlers.binary?.(ev.data);
      }
    };
    ws.onclose = () => {
      handlers.close?.();
      if (!closed) {
        setTimeout(connect, retry);
        retry = Math.min(retry * 2, 8000);
      }
    };
    ws.onerror = () => ws.close();
  }
  connect();
  return {
    close() { closed = true; ws?.close(); },
    get ready() { return ws && ws.readyState === WebSocket.OPEN; },
  };
}
