// App-wide state with change notifications, kept live by the /stream/state WS.

import { api, openWs } from "./api.js";

const state = {
  loaded: false,         // first captures fetch landed (skeleton gate)
  captures: [],          // capture status dicts
  devices: [],
  trunking: [],          // trunking system status dicts
  scanners: [],
  connected: false,
};

const listeners = new Set();

export function getState() { return state; }

export function subscribe(fn) {
  listeners.add(fn);
  return () => listeners.delete(fn);
}

function notify(what) {
  for (const fn of listeners) {
    try { fn(what); } catch (e) { console.error(e); }
  }
}

export async function refreshCaptures() {
  state.captures = await api.get("/captures");
  state.loaded = true;
  notify("captures");
}

export async function refreshDevices() {
  state.devices = await api.get("/devices");
  notify("devices");
}

export async function refreshTrunking() {
  state.trunking = await api.get("/trunking/systems");
  notify("trunking");
}

export async function refreshScanners() {
  state.scanners = await api.get("/scanners");
  notify("scanners");
}

export async function refreshAll() {
  await Promise.allSettled([
    refreshCaptures(), refreshDevices(), refreshTrunking(), refreshScanners(),
  ]);
}

let stateWs = null;

export function connectStateWs() {
  if (stateWs) return;
  stateWs = openWs("/stream/state", {
    open() { state.connected = true; notify("conn"); refreshAll(); },
    close() { state.connected = false; notify("conn"); },
    json(evt) {
      // {entity: capture|channel|..., id, change: created|updated|deleted, data}
      if (evt.entity === "capture" || evt.entity === "channel") refreshCaptures();
      else if (evt.entity === "trunking") refreshTrunking();
      else if (evt.entity === "scanner") refreshScanners();
      notify(`event:${evt.entity}`);
    },
  });
}

// periodic fallback refresh (RSSI etc. are poll-only)
setInterval(() => {
  if (state.connected) refreshCaptures().catch(() => {});
}, 3000);
setInterval(() => {
  if (state.connected) { refreshTrunking().catch(() => {}); }
}, 4000);
