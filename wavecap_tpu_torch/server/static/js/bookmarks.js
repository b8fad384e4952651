// Client-side persistence for the bookmark manager: frequency bookmarks,
// tune history, and memory banks (capture + channel snapshots).  The
// reference frontend keeps the same three stores in localStorage
// (hooks/useBookmarks.ts, useFrequencyHistory.ts, useMemoryBanks.ts);
// this module is their vanilla-JS equivalent with the same shapes.

const KEY = "wavecap.bookmarks";
const HISTORY_KEY = "wavecap.freq_history";
const BANKS_KEY = "wavecap.memory_banks";
const MAX_HISTORY = 50;
const MAX_BANKS = 50;

function load(key) {
  try { return JSON.parse(localStorage.getItem(key)) || []; }
  catch { return []; }
}

function save(key, list) {
  try { localStorage.setItem(key, JSON.stringify(list)); }
  catch { /* storage full/denied: bookmarks are a convenience, not state */ }
}

function uid(prefix) {
  return `${prefix}_${Date.now()}_${Math.random().toString(36).slice(2, 9)}`;
}

// ---------------------------------------------------------------------------
// bookmarks: {id, name, freqHz, mode, notes, added}
// ---------------------------------------------------------------------------

export function listBookmarks() {
  return load(KEY);
}

export function addBookmark(mark) {
  const list = listBookmarks();
  if (list.some((b) => b.freqHz === mark.freqHz && b.mode === mark.mode)) return null;
  const entry = { id: uid("bm"), notes: "", ...mark, added: Date.now() };
  list.push(entry);
  list.sort((a, b) => a.freqHz - b.freqHz);
  save(KEY, list);
  return entry;
}

export function updateBookmark(id, updates) {
  save(KEY, listBookmarks().map((b) => (b.id === id ? { ...b, ...updates } : b)));
}

export function removeBookmark(mark) {
  save(KEY, listBookmarks().filter(
    (b) => (mark.id ? b.id !== mark.id
                    : !(b.freqHz === mark.freqHz && b.mode === mark.mode))));
}

export function bookmarkNear(freqHz, toleranceHz = 1000) {
  return listBookmarks().find((b) => Math.abs(b.freqHz - freqHz) < toleranceHz);
}

export function exportBookmarks() {
  return JSON.stringify(
    { bookmarks: listBookmarks(), memoryBanks: listMemoryBanks() }, null, 2);
}

export function importBookmarks(text) {
  const data = JSON.parse(text);
  const marks = Array.isArray(data) ? data : data.bookmarks || [];
  let added = 0;
  for (const m of marks) {
    if (typeof m.freqHz !== "number") continue;
    if (addBookmark({ name: m.name || "", freqHz: m.freqHz,
                      mode: m.mode || "nbfm", notes: m.notes || "" })) added++;
  }
  for (const bank of (data.memoryBanks || [])) {
    if (bank && bank.captureConfig) saveMemoryBank(bank.name, bank.captureConfig,
                                                   bank.channels || []);
  }
  return added;
}

// ---------------------------------------------------------------------------
// tune history: {freqHz, mode, time} most-recent-first, deduped
// ---------------------------------------------------------------------------

export function listHistory() {
  return load(HISTORY_KEY);
}

export function pushHistory(freqHz, mode) {
  let list = load(HISTORY_KEY).filter(
    (h) => !(h.freqHz === freqHz && h.mode === mode));
  list.unshift({ freqHz, mode, time: Date.now() });
  if (list.length > MAX_HISTORY) list = list.slice(0, MAX_HISTORY);
  save(HISTORY_KEY, list);
}

export function clearHistory() {
  save(HISTORY_KEY, []);
}

// ---------------------------------------------------------------------------
// memory banks: a named snapshot of one capture's config + channels that
// can be re-created through the REST API later
// ---------------------------------------------------------------------------

export function listMemoryBanks() {
  return load(BANKS_KEY);
}

export function saveMemoryBank(name, captureConfig, channels) {
  let list = load(BANKS_KEY);
  const entry = {
    id: uid("bank"),
    name: name || `Bank ${list.length + 1}`,
    timestamp: Date.now(),
    captureConfig,
    channels,
  };
  list.unshift(entry);
  if (list.length > MAX_BANKS) list = list.slice(0, MAX_BANKS);
  save(BANKS_KEY, list);
  return entry;
}

export function removeMemoryBank(id) {
  save(BANKS_KEY, load(BANKS_KEY).filter((b) => b.id !== id));
}
