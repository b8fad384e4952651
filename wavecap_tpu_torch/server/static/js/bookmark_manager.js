// Bookmark manager dialog: three tabs — frequency bookmarks, tune
// history, and memory banks (capture + channel snapshots that can be
// re-created through the REST API).  Vanilla equivalent of the reference
// frontend's BookmarkManager.react.tsx + useFrequencyHistory +
// useMemoryBanks.

import { api } from "./api.js";
import { el, clear, fmtHz, fmtTime, dialog, tabs, modal, toast, confirmDlg } from "./ui.js";
import {
  listBookmarks, addBookmark, updateBookmark, removeBookmark,
  listHistory, clearHistory, pushHistory,
  listMemoryBanks, saveMemoryBank, removeMemoryBank,
  exportBookmarks, importBookmarks,
} from "./bookmarks.js";

const MODES = ["nbfm", "wbfm", "am", "ssb", "sam", "p25", "dmr"];

async function editBookmarkDlg(mark) {
  const vals = await modal({
    title: mark ? "Edit bookmark" : "New bookmark",
    submitLabel: "Save",
    fields: [
      { name: "name", label: "Name", value: mark?.name || "" },
      { name: "freqMhz", label: "Frequency (MHz)", type: "number",
        value: mark ? (mark.freqHz / 1e6).toFixed(4) : "", step: "0.0001" },
      { name: "mode", label: "Mode", type: "select", value: mark?.mode || "nbfm",
        options: MODES.map((m) => ({ value: m })) },
      { name: "notes", label: "Notes", value: mark?.notes || "", optional: true },
    ],
  });
  if (!vals || !Number.isFinite(vals.freqMhz)) return null;
  return {
    name: vals.name, freqHz: Math.round(vals.freqMhz * 1e6),
    mode: vals.mode, notes: vals.notes || "",
  };
}

function downloadJson(filename, text) {
  const a = el("a", {
    href: URL.createObjectURL(new Blob([text], { type: "application/json" })),
    download: filename,
  });
  document.body.append(a);
  a.click();
  a.remove();
}

// opts: {capture, channels, onTune(freqHz, mode)}  all optional
export function openBookmarkManager(opts = {}) {
  let active = "bookmarks";

  const { body, close } = dialog("Bookmarks", () => {}, { wide: true });

  const tuneBtn = (freqHz, mode) => opts.onTune
    ? el("button", { class: "small", onClick: () => {
        pushHistory(freqHz, mode);
        opts.onTune(freqHz, mode);
        close();
      } }, "Tune")
    : null;

  function bookmarksTab() {
    const marks = listBookmarks();
    return el("div", {},
      el("div", { class: "dlg-toolbar" },
        el("button", { class: "small", onClick: async () => {
          const m = await editBookmarkDlg(null);
          if (m) { addBookmark(m); render(); }
        } }, "＋ Add"),
        el("button", { class: "small", onClick: () =>
          downloadJson("wavecap-bookmarks.json", exportBookmarks()) }, "Export"),
        el("button", { class: "small", onClick: async () => {
          const vals = await modal({
            title: "Import bookmarks (JSON)", submitLabel: "Import",
            fields: [{ name: "text", label: "Paste exported JSON", type: "textarea" }],
          });
          if (!vals?.text) return;
          try { toast(`Imported ${importBookmarks(vals.text)} bookmarks`); }
          catch (e) { toast(`Import failed: ${e.message}`, true); }
          render();
        } }, "Import")),
      marks.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Name"), el("th", {}, "Frequency"), el("th", {}, "Mode"),
              el("th", {}, "Notes"), el("th", {}, ""))),
            el("tbody", {}, marks.map((m) => el("tr", {},
              el("td", {}, m.name || el("span", { class: "muted" }, "—")),
              el("td", { class: "mono" }, fmtHz(m.freqHz)),
              el("td", {}, el("span", { class: "badge" }, m.mode)),
              el("td", { class: "muted" }, m.notes || ""),
              el("td", { class: "row-actions" },
                tuneBtn(m.freqHz, m.mode),
                el("button", { class: "small", onClick: async () => {
                  const upd = await editBookmarkDlg(m);
                  if (upd) { updateBookmark(m.id, upd); render(); }
                } }, "Edit"),
                el("button", { class: "small danger", onClick: () => {
                  removeBookmark(m); render();
                } }, "✕"))))))
        : el("div", { class: "empty" }, "No bookmarks yet — add one or ★ a channel"));
  }

  function historyTab() {
    const hist = listHistory();
    return el("div", {},
      el("div", { class: "dlg-toolbar" },
        el("button", { class: "small", onClick: () => { clearHistory(); render(); } },
          "Clear history")),
      hist.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Frequency"), el("th", {}, "Mode"),
              el("th", {}, "When"), el("th", {}, ""))),
            el("tbody", {}, hist.map((h) => el("tr", {},
              el("td", { class: "mono" }, fmtHz(h.freqHz)),
              el("td", {}, el("span", { class: "badge" }, h.mode || "—")),
              el("td", { class: "muted" }, fmtTime(h.time / 1000)),
              el("td", { class: "row-actions" },
                tuneBtn(h.freqHz, h.mode),
                el("button", { class: "small", onClick: () => {
                  addBookmark({ name: "", freqHz: h.freqHz, mode: h.mode || "nbfm" });
                  toast("Bookmarked");
                } }, "★"))))))
        : el("div", { class: "empty" }, "No tune history yet"));
  }

  function banksTab() {
    const banks = listMemoryBanks();
    return el("div", {},
      el("div", { class: "dlg-toolbar" },
        opts.capture
          ? el("button", { class: "small", onClick: async () => {
              const vals = await modal({
                title: "Save memory bank", submitLabel: "Save",
                fields: [{ name: "name", label: "Bank name", value: "" }],
              });
              if (vals === null) return;
              const cap = opts.capture;
              saveMemoryBank(vals.name, {
                centerHz: cap.centerHz, sampleRate: cap.sampleRate,
                gainDb: cap.gainDb ?? null, ppm: cap.ppm ?? null,
                bandwidthHz: cap.bandwidthHz ?? null,
                antenna: cap.antenna ?? null, deviceId: cap.deviceId,
              }, (opts.channels || []).map((ch) => ({
                mode: ch.mode, frequencyHz: ch.frequencyHz,
                squelchDb: ch.squelchDb ?? null, name: ch.name || null,
              })));
              render();
            } }, "＋ Save current capture")
          : el("span", { class: "muted" }, "Select a capture to save a bank")),
      banks.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Name"), el("th", {}, "Center"), el("th", {}, "Channels"),
              el("th", {}, "Saved"), el("th", {}, ""))),
            el("tbody", {}, banks.map((b) => el("tr", {},
              el("td", {}, b.name),
              el("td", { class: "mono" }, fmtHz(b.captureConfig?.centerHz)),
              el("td", { class: "num" }, (b.channels || []).length),
              el("td", { class: "muted" }, fmtTime(b.timestamp / 1000)),
              el("td", { class: "row-actions" },
                el("button", { class: "small", onClick: () => loadBank(b) }, "Load"),
                el("button", { class: "small danger", onClick: () => {
                  removeMemoryBank(b.id); render();
                } }, "✕"))))))
        : el("div", { class: "empty" }, "No memory banks saved"));
  }

  async function loadBank(bank) {
    if (!(await confirmDlg(`Create a new capture from "${bank.name}"?`))) return;
    try {
      const cfg = bank.captureConfig || {};
      const cap = await api.post("/captures", {
        centerHz: cfg.centerHz, sampleRate: cfg.sampleRate,
        ...(cfg.gainDb != null ? { gainDb: cfg.gainDb } : {}),
        ...(cfg.ppm != null ? { ppm: cfg.ppm } : {}),
        ...(cfg.bandwidthHz != null ? { bandwidthHz: cfg.bandwidthHz } : {}),
        ...(cfg.antenna ? { antenna: cfg.antenna } : {}),
        ...(cfg.deviceId ? { deviceId: cfg.deviceId } : {}),
        autoStart: true,
      });
      for (const ch of bank.channels || []) {
        await api.post(`/captures/${cap.id}/channels`, {
          mode: ch.mode, frequencyHz: ch.frequencyHz,
          ...(ch.squelchDb != null ? { squelchDb: ch.squelchDb } : {}),
          ...(ch.name ? { name: ch.name } : {}),
        });
      }
      toast(`Capture restored from "${bank.name}"`);
      close();
      opts.onLoaded?.();
    } catch (e) {
      toast(`Load failed: ${e.message}`, true);
    }
  }

  function render() {
    clear(body);
    body.append(
      tabs([
        { key: "bookmarks", label: `Bookmarks (${listBookmarks().length})` },
        { key: "history", label: `History (${listHistory().length})` },
        { key: "banks", label: `Memory banks (${listMemoryBanks().length})` },
      ], active, (k) => { active = k; render(); }),
      active === "bookmarks" ? bookmarksTab()
        : active === "history" ? historyTab() : banksTab());
  }
  render();
}
