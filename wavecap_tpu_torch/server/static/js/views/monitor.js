// Monitor view: captures, live spectrum/waterfall, channel cards with
// tuning, squelch, audio playback, stream links, decoder message feeds,
// classified-channel overlay and a bookmark bar.
// Mirrors the reference frontend's RadioPanel/ChannelList/ChannelCard/
// ChannelSettings/RdsDisplay/StreamLinks/BookmarkManager features
// (frontend/src/features/channel/, components/BookmarkManager.react.tsx).

import { api } from "../api.js";
import {
  el, clear, fmtHz, fmtTime, badge, smeter, toast, modal, confirmDlg,
  freqInput, audioWaveform, statusPill, splitButton, skeleton } from "../ui.js";
import { getState, subscribe, refreshCaptures } from "../store.js";
import { SpectrumView } from "../spectrum.js";
import { ChannelPlayer } from "../audio.js";
import {
  listBookmarks, addBookmark, removeBookmark, pushHistory,
} from "../bookmarks.js";
import { openBookmarkManager } from "../bookmark_manager.js";
import { messageTicker } from "./messages.js";

// one shared ticker instance so re-renders don't stack poll timers
let _ticker = null;
function messageTickerLazy() {
  if (!_ticker || !_ticker.isConnected) _ticker = messageTicker();
  return _ticker;
}

const MODES = ["nbfm", "wbfm", "am", "ssb", "sam", "p25", "dmr"];

const players = new Map();   // chid -> ChannelPlayer (persist across rerenders)
const expanded = new Set();  // chid set: expanded channel cards
const msgCache = new Map();  // chid -> {time, list}
let spectrum = null;         // active SpectrumView
let spectrumCid = null;
let selectedCid = null;
let classified = null;       // classified-channels payload for selected capture
let classifiedTimer = null;
let vuTimer = null;
let streamFormats = null;

function stopSpectrum() {
  spectrum?.close();
  spectrum = null;
  spectrumCid = null;
  clearInterval(classifiedTimer);
  classifiedTimer = null;
  classified = null;
}

export function unmountMonitor() {
  stopSpectrum();
  clearInterval(vuTimer);
  vuTimer = null;
  // keep audio playing across tab switches on purpose
}

async function createCaptureDlg() {
  const devices = getState().devices;
  const vals = await modal({
    title: "New capture",
    fields: [
      { name: "centerHz", label: "Center frequency (MHz)", type: "number",
        value: 100, step: "0.001" },
      { name: "sampleRate", label: "Sample rate (Hz)", type: "select",
        value: "2400000",
        options: [
          { value: "800000", label: "800 kHz" },
          { value: "2400000", label: "2.4 MHz" },
          { value: "9600000", label: "9.6 MHz" },
          { value: "10000000", label: "10 MHz" },
        ] },
      { name: "gainDb", label: "Gain (dB, blank = auto)", type: "number",
        optional: true, value: "" },
      ...(devices.length > 1 ? [{
        name: "deviceId", label: "Device", type: "select",
        options: devices.map((d) => ({ value: d.id, label: d.nickname || d.label || d.id })),
      }] : []),
      { name: "autoStart", label: "Start immediately", type: "checkbox", value: true },
    ],
  });
  if (!vals) return;
  try {
    await api.post("/captures", {
      centerHz: vals.centerHz * 1e6,
      sampleRate: Number(vals.sampleRate),
      deviceId: vals.deviceId,
      ...(vals.gainDb !== undefined ? { gainDb: vals.gainDb } : {}),
      autoStart: vals.autoStart,
    });
    toast("Capture created");
    refreshCaptures();
  } catch (e) { toast(e.message, true); }
}

async function addChannelDlg(cap, presetHz, presetMode) {
  let hint = null;
  if (presetHz) {
    try { hint = await api.get(`/frequencies/identify?hz=${presetHz}`); }
    catch { /* optional */ }
  }
  const vals = await modal({
    title: "New channel",
    fields: [
      { name: "name", label: "Name", value: hint?.name || "" },
      { name: "mode", label: "Mode", type: "select",
        value: presetMode || hint?.modeHint || "nbfm",
        options: MODES.map((m) => ({ value: m })) },
      { name: "frequencyHz", label: "Frequency (MHz)", type: "number",
        value: ((presetHz ?? cap.centerHz) / 1e6).toFixed(4), step: "0.0001" },
      { name: "squelchDb", label: "Squelch (dBFS, blank = open)", type: "number",
        optional: true, value: "" },
    ],
  });
  if (!vals) return;
  try {
    await api.post(`/captures/${cap.id}/channels`, {
      name: vals.name,
      mode: vals.mode,
      frequencyHz: vals.frequencyHz * 1e6,
      ...(vals.squelchDb !== undefined ? { squelchDb: vals.squelchDb } : {}),
    });
    toast("Channel added");
    refreshCaptures();
  } catch (e) { toast(e.message, true); }
}

// ---------------------------------------------------------------------------
// channel cards
// ---------------------------------------------------------------------------

function togglePlay(ch) {
  if (players.has(ch.id)) {
    players.get(ch.id).close();
    players.delete(ch.id);
  } else {
    players.set(ch.id, new ChannelPlayer(`/stream/channels/${ch.id}`));
  }
  render();
}

const squelchDebounce = new Map();

function patchSquelch(ch, value) {
  clearTimeout(squelchDebounce.get(ch.id));
  squelchDebounce.set(ch.id, setTimeout(() => {
    api.patch(`/channels/${ch.id}`, { squelchDb: value })
      .catch((e) => toast(e.message, true));
  }, 300));
}

function streamLinks(ch) {
  const base = `${location.origin}/api/v1/stream/channels/${ch.id}`;
  const links = [["pcm (ws)", `${base}`.replace(/^http/, "ws")]];
  for (const fmt of streamFormats || []) {
    if (["mp3", "opus", "aac"].includes(fmt))
      links.push([fmt, `${base}.${fmt}`]);
  }
  links.push(["raw pcm", `${base}.pcm`]);
  return el("div", { class: "stream-links" },
    el("span", { class: "muted" }, "streams:"),
    links.map(([label, url]) =>
      el("a", { href: url, class: "mono", title: "copy URL",
        onClick: (e) => {
          e.preventDefault();
          navigator.clipboard?.writeText(url);
          toast(`${label} URL copied`);
        } }, label)));
}

function msgLine(m) {
  if (m.decoder === "rds") {
    const pi = m.pi !== undefined && m.pi !== null
      ? "PI 0x" + Number(m.pi).toString(16).toUpperCase() : "";
    return `${fmtTime(m.time)}  RDS ${pi}  PS "${m.ps ?? ""}"  RT "${m.radiotext ?? m.rt ?? ""}"`;
  }
  if (m.decoder === "pocsag")
    return `${fmtTime(m.time)}  POCSAG ${m.address ?? ""}${m.alias ? ` (${m.alias})` : ""}  ${m.message ?? m.text ?? ""}`;
  if (m.decoder === "flex")
    return `${fmtTime(m.time)}  FLEX ${m.capcode ?? ""}  ${m.message ?? m.text ?? ""}`;
  if (m.decoder === "p25")
    return `${fmtTime(m.time)}  P25 ${m.kind ?? m.opcodeName ?? ""}  ${JSON.stringify(m.fields ?? m)}`;
  if (m.decoder === "dmr")
    return `${fmtTime(m.time)}  DMR ${m.kind ?? ""}  ${JSON.stringify(m.fields ?? m)}`;
  return `${fmtTime(m.time)}  ${m.decoder}  ${JSON.stringify(m)}`;
}

async function fetchMessages(chid) {
  const c = msgCache.get(chid);
  if (c && (c.inflight || Date.now() - c.time < 2500)) return c.list || [];
  // mark in-flight BEFORE awaiting: the 150 ms poll timer must not stack
  // duplicate requests while one is pending on a slow server
  msgCache.set(chid, { ...(c || {}), inflight: true });
  try {
    const list = await api.get(`/channels/${chid}/messages?limit=40`);
    msgCache.set(chid, { time: Date.now(), list, inflight: false });
    const box = document.getElementById(`msgs-${chid}`);
    if (box) {
      box.textContent = list.length
        ? list.map(msgLine).join("\n") : "no decoder messages yet";
      box.scrollTop = box.scrollHeight;
    }
    // dedicated RDS readout (reference RdsDisplay.tsx): latest PS / PI /
    // radiotext as a styled strip above the raw message log
    const rdsEl = document.getElementById(`rds-${chid}`);
    if (rdsEl) {
      const rds = [...list].reverse().find((m) => m.decoder === "rds");
      if (rds) {
        rdsEl.style.display = "";
        rdsEl.replaceChildren(
          el("span", { class: "rds-ps" }, rds.ps || "········"),
          rds.pi !== undefined && rds.pi !== null
            ? el("span", { class: "mono muted" },
                ` PI 0x${Number(rds.pi).toString(16).toUpperCase()}`)
            : "",
          el("span", { class: "rds-rt" },
            ` ${rds.radiotext ?? rds.rt ?? ""}`));
      } else {
        rdsEl.style.display = "none";
      }
    }
    return list;
  } catch {
    // clear in-flight (with a fresh time so failures back off, not spin)
    msgCache.set(chid, { time: Date.now(), list: c?.list || [], inflight: false });
    return [];
  }
}

function channelDetail(cap, ch) {
  const playing = players.get(ch.id);
  const sqOn = ch.squelchDb !== null && ch.squelchDb !== undefined;
  const sqSlider = el("input", {
    type: "range", min: -120, max: 0, step: 1,
    value: sqOn ? ch.squelchDb : -120, disabled: !sqOn,
    onInput: (e) => {
      const v = Number(e.target.value);
      sqVal.textContent = `${v} dB`;
      patchSquelch(ch, v);
    },
  });
  const sqVal = el("span", { class: "mono muted" },
    sqOn ? `${ch.squelchDb} dB` : "open");
  const sqToggle = el("input", { type: "checkbox", onChange: (e) => {
    const on = e.target.checked;
    sqSlider.disabled = !on;
    const v = on ? Number(sqSlider.value) : null;
    sqVal.textContent = on ? `${sqSlider.value} dB` : "open";
    api.patch(`/channels/${ch.id}`, { squelchDb: v })
      .catch((er) => toast(er.message, true));
  } });
  sqToggle.checked = sqOn;

  // VU meter driven by the shared poll timer (canvas id looked up there)
  const vu = el("canvas", {
    id: `vu-${ch.id}`, width: 160, height: 10, class: "vu",
  });

  fetchMessages(ch.id);
  return el("tr", { class: "detail-row" },
    el("td", { colspan: 6 },
      el("div", { class: "chan-detail" },
        el("div", { class: "chan-controls" },
          el("label", { class: "inline" }, "Squelch", sqToggle, sqSlider, sqVal),
          el("label", { class: "inline" }, "VU", vu,
            playing ? null : el("span", { class: "muted" }, "(not playing)")),
          streamLinks(ch)),
        el("div", { class: "rds-strip", id: `rds-${ch.id}`,
          style: "display:none" }),
        el("div", { class: "logbox", id: `msgs-${ch.id}`,
          style: "max-height:120px; margin-top:6px" },
          "loading messages…"))));
}

function channelRow(cap, ch) {
  const playing = players.has(ch.id);
  const isOpen = expanded.has(ch.id);
  const playBtn = el("button", {
    class: `small ${playing ? "primary" : ""}`,
    onClick: () => togglePlay(ch),
  }, playing ? "■ Stop" : "▶ Listen");

  const vol = el("input", {
    type: "range", min: 0, max: 1, step: 0.05,
    value: playing ? players.get(ch.id).volume : 1,
    style: "width:70px",
    onInput: (e) => {
      const p = players.get(ch.id);
      if (p) p.volume = Number(e.target.value);
    },
  });

  const row = el("tr", {},
    el("td", {},
      el("span", { class: "clickable", onClick: () => {
        if (isOpen) expanded.delete(ch.id); else expanded.add(ch.id);
        render();
      } }, isOpen ? "▾ " : "▸ "),
      el("span", { class: "mono" }, ch.name || ch.id)),
    el("td", {}, ch.mode),
    el("td", { class: "mono clickable", title: "Retune",
      onClick: async () => {
        const vals = await modal({
          title: `Retune ${ch.name || ch.id}`,
          fields: [{ name: "f", label: "Frequency (MHz)", type: "number",
            value: (ch.frequencyHz / 1e6).toFixed(4), step: "0.0001" }],
          submitLabel: "Tune",
        });
        if (!vals) return;
        try {
          await api.patch(`/channels/${ch.id}`, { frequencyHz: vals.f * 1e6 });
          pushHistory(Math.round(vals.f * 1e6), ch.mode);
          refreshCaptures();
        } catch (e) { toast(e.message, true); }
      } }, fmtHz(ch.frequencyHz)),
    el("td", {}, smeter(ch.rssiDb)),
    el("td", {}, playBtn, " ", el("span", { class: "vol" }, vol),
      playing ? audioWaveform(players.get(ch.id), { width: 90, height: 18 }) : null),
    el("td", {},
      el("button", { class: "small", title: "Bookmark this frequency",
        onClick: () => {
          addBookmark({ name: ch.name || ch.id, freqHz: ch.frequencyHz,
            mode: ch.mode });
          toast("Bookmarked");
          render();
        } }, "☆"),
      " ",
      el("button", { class: "small", title: "DSP settings",
        onClick: () => dspSettingsDlg(ch) }, "𝑓"),
      " ",
      el("button", { class: "small", title: "Decoder attachments",
        onClick: () => attachmentsDlg(ch) }, "⚙"),
      " ",
      el("button", { class: "small danger", onClick: async () => {
        if (!(await confirmDlg(`Delete channel ${ch.name || ch.id}?`))) return;
        players.get(ch.id)?.close();
        players.delete(ch.id);
        expanded.delete(ch.id);
        await api.del(`/channels/${ch.id}`).catch((e) => toast(e.message, true));
        refreshCaptures();
      } }, "✕")));
  return isOpen ? [row, channelDetail(cap, ch)] : [row];
}

// Per-mode DSP settings (reference ChannelSettings.tsx / api.py channel
// update): [camelCase API field, snake_case echo key, label, type,
// default, toUi?] — toUi converts the stored value to display units.
const DSP_FORMS = {
  wbfm: [
    ["enableDeemphasis", "enable_deemphasis", "Deemphasis", "checkbox", true],
    ["deemphasisTauUs", "deemphasis_tau", "Deemphasis tau (µs)", "number", 75,
      (v) => v * 1e6],
    ["enableMpxFilter", "enable_mpx_filter", "MPX lowpass", "checkbox", true],
    ["mpxCutoffHz", "mpx_cutoff_hz", "MPX cutoff (Hz)", "number", 15000],
    ["enableFmHighpass", "enable_highpass", "Audio highpass", "checkbox", false],
    ["fmHighpassHz", "highpass_hz", "Highpass (Hz)", "number", 100],
  ],
  nbfm: [
    ["maxDeviationHz", "max_deviation_hz", "Max deviation (Hz)", "number", 5000],
    ["enableDeemphasis", "enable_deemphasis", "Deemphasis", "checkbox", false],
    ["enableFmHighpass", "enable_highpass", "Voice highpass", "checkbox", true],
    ["fmHighpassHz", "highpass_hz", "Highpass (Hz)", "number", 300],
    ["enableFmLowpass", "enable_lowpass", "Voice lowpass", "checkbox", true],
    ["fmLowpassHz", "lowpass_hz", "Lowpass (Hz)", "number", 3000],
  ],
  am: [
    ["enableAgc", "enable_agc", "AGC", "checkbox", true],
    ["agcTargetDb", "agc_target_db", "AGC target (dB)", "number", -20],
    ["enableAmHighpass", "enable_highpass", "Audio highpass", "checkbox", true],
    ["amHighpassHz", "highpass_hz", "Highpass (Hz)", "number", 100],
    ["enableAmLowpass", "enable_lowpass", "Audio lowpass", "checkbox", true],
    ["amLowpassHz", "lowpass_hz", "Lowpass (Hz)", "number", 5000],
  ],
  ssb: [
    ["enableSsbBandpass", "enable_bandpass", "Bandpass", "checkbox", true],
    ["ssbBandpassLowHz", "bandpass_low", "Bandpass low (Hz)", "number", 300],
    ["ssbBandpassHighHz", "bandpass_high", "Bandpass high (Hz)", "number", 3000],
    ["ssbBfoOffsetHz", "bfo_offset_hz", "BFO offset (Hz)", "number", 1500],
    ["enableAgc", "enable_agc", "AGC", "checkbox", true],
  ],
};
DSP_FORMS.sam = DSP_FORMS.am;
DSP_FORMS.usb = DSP_FORMS.ssb;
DSP_FORMS.lsb = DSP_FORMS.ssb;
const DSP_COMMON = [
  ["enableNoiseBlanker", "enable_noise_blanker", "Noise blanker", "checkbox", false],
  ["noiseBlankerThresholdDb", "noise_blanker_threshold_db",
    "Blanker threshold (dB)", "number", 10],
  ["enableNoiseReduction", "enable_noise_reduction", "Noise reduction",
    "checkbox", false],
  ["noiseReductionDb", "noise_reduction_db", "NR depth (dB)", "number", 12],
];

async function dspSettingsDlg(ch) {
  const rows = [...(DSP_FORMS[ch.mode] || []),
                ...(ch.mode === "p25" || ch.mode === "dmr" ? [] : DSP_COMMON)];
  if (!rows.length) { toast("No DSP settings for this mode"); return; }
  const dsp = ch.dsp || {};
  const fields = rows.map(([name, snake, label, type, def, toUi]) => {
    let cur = dsp[snake];
    if (cur !== undefined && toUi) cur = toUi(cur);
    return { name, label, type,
             value: cur !== undefined ? cur : def,
             step: "any" };
  });
  fields.push({
    name: "notch", label: "Notch frequencies (Hz, comma-sep)",
    value: (dsp.notch_frequencies || []).join(", "),
  });
  const vals = await modal({
    title: `DSP — ${ch.name || ch.id} (${ch.mode})`,
    fields, submitLabel: "Apply",
  });
  if (!vals) return;
  const body = {};
  for (const [name, , , type] of rows) {
    if (type === "checkbox") body[name] = !!vals[name];
    else if (vals[name] !== "" && vals[name] !== undefined)
      body[name] = Number(vals[name]);
  }
  const notch = String(vals.notch || "").split(",")
    .map((s) => Number(s.trim())).filter((f) => f > 0);
  body.notchFrequencies = notch.length ? notch : null;
  try {
    await api.patch(`/channels/${ch.id}`, body);
    toast("DSP settings applied");
    refreshCaptures();
  } catch (e) { toast(e.message, true); }
}

async function attachmentsDlg(ch) {
  let current = [];
  try { current = await api.get(`/channels/${ch.id}/attachments`); } catch {}
  const kinds = ["rds", "pocsag", "flex", "p25", "dmr"];
  const active = new Set(current.map((a) => a.kind ?? a));
  const vals = await modal({
    title: `Attachments — ${ch.name || ch.id}`,
    fields: kinds.map((k) => ({
      name: k, label: k.toUpperCase(), type: "checkbox", value: active.has(k),
    })),
    submitLabel: "Apply",
  });
  if (!vals) return;
  for (const k of kinds) {
    try {
      if (vals[k] && !active.has(k))
        await api.post(`/channels/${ch.id}/attachments`, { kind: k });
      else if (!vals[k] && active.has(k))
        await api.del(`/channels/${ch.id}/attachments/${k}`);
    } catch (e) { toast(`${k}: ${e.message}`, true); }
  }
  toast("Attachments updated");
}

// ---------------------------------------------------------------------------
// classified channels + bookmarks
// ---------------------------------------------------------------------------

async function createTrunkingFromCC(freqHz) {
  // reference CreateTrunkingWizard: seed a P25 system from a classified
  // control channel, then hand off to the Trunking tab
  const vals = await modal({
    title: `Trunking system on ${(freqHz / 1e6).toFixed(4)} MHz`,
    fields: [
      { name: "id", label: "System id", value: "sys1", required: true,
        validate: (v) => /^[a-zA-Z0-9_-]{1,32}$/.test(v)
          ? null : "letters/digits/dash only" },
      { name: "name", label: "Name", value: "" },
      { name: "sampleRate", label: "Sample rate (Hz)", type: "select",
        value: "2400000",
        options: [
          { value: "960000", label: "960 kHz" },
          { value: "2400000", label: "2.4 MHz" },
        ] },
      { name: "start", label: "Start immediately", type: "checkbox",
        value: true },
    ],
  });
  if (!vals) return;
  try {
    await api.post("/trunking/systems", {
      id: vals.id, name: vals.name, control_channels: [freqHz],
      sample_rate: Number(vals.sampleRate), autoStart: vals.start,
    });
    toast("Trunking system created — see the Trunking tab");
  } catch (e) { toast(e.message, true); }
}

async function pollClassified(cid) {
  try { classified = await api.get(`/captures/${cid}/classified-channels`); }
  catch { classified = null; }
}

function classifiedTable(cap) {
  const chans = classified?.channels || [];
  if (!chans.length) return null;
  return el("details", { class: "classified" },
    el("summary", {}, `Classified signals (${chans.length})`),
    el("table", {},
      el("thead", {}, el("tr", {},
        el("th", {}, "Frequency"), el("th", {}, "Kind"),
        el("th", { class: "num" }, "Occupancy"),
        el("th", { class: "num" }, "Mean dB"), el("th", {}, ""))),
      el("tbody", {}, chans.map((c) => el("tr", {},
        el("td", { class: "mono" }, fmtHz(c.frequency_hz)),
        el("td", {}, c.kind),
        el("td", { class: "num" }, `${(c.occupancy * 100).toFixed(0)}%`),
        el("td", { class: "num" }, c.mean_db?.toFixed(1)),
        el("td", {},
          el("button", { class: "small",
            onClick: () => addChannelDlg(cap, c.frequency_hz,
              c.kind === "control" ? "p25" : undefined) }, "+ add"),
          c.kind === "control"
            ? el("button", { class: "small", style: "margin-left:4px",
                title: "create a trunking system on this control channel",
                onClick: () => createTrunkingFromCC(c.frequency_hz) },
                "+ trunking")
            : null))))));
}

function bookmarkBar(cap) {
  const marks = listBookmarks();
  if (!marks.length) return null;
  return el("div", { class: "bookmarks" },
    el("span", { class: "muted" }, "★"),
    marks.map((b) => el("span", { class: "bookmark" },
      el("a", { title: `${fmtHz(b.freqHz)} ${b.mode}`,
        onClick: () => addChannelDlg(cap, b.freqHz, b.mode) },
        `${b.name || fmtHz(b.freqHz)}`),
      el("a", { class: "x", title: "remove", onClick: () => {
        removeBookmark(b);
        render();
      } }, "×"))));
}

// ---------------------------------------------------------------------------

function capturePanel(cap) {
  const isSel = cap.id === selectedCid;
  const head = el("h2", {},
    el("span", { class: "clickable", onClick: () => {
      selectedCid = isSel ? null : cap.id;
      render();
    } }, `${isSel ? "▾" : "▸"} Capture ${cap.id}`),
    statusPill(cap.state),
    freqInput(cap.centerHz, (hz) => {
      // live front-end retune without stream teardown (engine slot banks)
      api.patch(`/captures/${cap.id}`, { centerHz: hz })
        .then(() => { pushHistory(hz, "capture"); refreshCaptures(); })
        .catch((e) => toast(e.message, true));
    }, { stepHz: 100_000 }),
    el("span", { class: "muted mono" }, `@ ${fmtHz(cap.sampleRate)}`),
    el("span", { class: "spacer" }),
    cap.state === "running"
      ? el("button", { class: "small", onClick: () =>
          api.post(`/captures/${cap.id}/stop`).then(refreshCaptures) }, "Stop")
      : el("button", { class: "small primary", onClick: () =>
          api.post(`/captures/${cap.id}/start`).then(refreshCaptures)
            .catch((e) => toast(e.message, true)) }, "Start"),
    el("button", { class: "small", onClick: async () => {
      const vals = await modal({
        title: "Retune capture",
        fields: [
          { name: "f", label: "Center (MHz)", type: "number",
            value: (cap.centerHz / 1e6).toFixed(4), step: "0.001" },
          { name: "gain", label: "Gain (dB, blank = keep)", type: "number",
            optional: true, value: "" },
        ],
        submitLabel: "Tune",
      });
      if (!vals) return;
      api.patch(`/captures/${cap.id}`, {
        centerHz: vals.f * 1e6,
        ...(vals.gain !== undefined ? { gainDb: vals.gain } : {}),
      }).then(refreshCaptures).catch((e) => toast(e.message, true));
    } }, "Retune"),
    el("button", { class: "small", title: "Device settings",
      onClick: async () => {
        // reference DeviceSettingsModal/AdvancedSettings: gain, hardware
        // AGC, ppm correction, analog bandwidth, antenna port — applied
        // live (reader thread reconfigures between reads, no teardown)
        const vals = await modal({
          title: `Device settings — capture ${cap.id}`,
          fields: [
            { name: "gain", label: "Gain (dB, blank = auto)", type: "number",
              optional: true, value: cap.gainDb ?? "", step: "any" },
            { name: "agc", label: "Hardware AGC", type: "checkbox",
              value: !!cap.agc },
            { name: "ppm", label: "Frequency correction (ppm)", type: "number",
              value: cap.ppm ?? 0, step: "any" },
            { name: "bw", label: "Bandwidth (Hz, 0 = auto)", type: "number",
              value: cap.bandwidthHz ?? 0, step: "any" },
            { name: "antenna", label: "Antenna (blank = default)",
              value: cap.antenna ?? "", optional: true },
          ],
          submitLabel: "Apply",
        });
        if (!vals) return;
        api.patch(`/captures/${cap.id}`, {
          ...(vals.gain !== undefined ? { gainDb: vals.gain } : {}),
          agc: !!vals.agc,
          ppm: Number(vals.ppm || 0),
          bandwidthHz: Number(vals.bw || 0),  // 0 clears (auto)
          antenna: vals.antenna ?? "",        // "" clears (default port)
        }).then(refreshCaptures).catch((e) => toast(e.message, true));
      } }, "⚙"),
    el("button", { class: "small danger", onClick: async () => {
      if (!(await confirmDlg(`Delete capture ${cap.id}?`))) return;
      if (spectrumCid === cap.id) stopSpectrum();
      await api.del(`/captures/${cap.id}`).catch((e) => toast(e.message, true));
      refreshCaptures();
    } }, "✕"));

  const kids = [head];

  if (isSel) {
    if (cap.state === "running") {
      if (spectrumCid !== cap.id) {
        stopSpectrum();
        spectrum = new SpectrumView(cap.id, {
          onTune: (hz) => addChannelDlg(cap, hz),
          markers: () => {
            const c = getState().captures.find((x) => x.id === cap.id);
            return (c?.channels || []).map((ch) => ({
              id: ch.id, freqHz: ch.frequencyHz, name: ch.name || ch.mode,
            }));
          },
          onMarkerDrag: (chid, hz) => {
            api.patch(`/channels/${chid}`, { frequencyHz: hz })
              .then(refreshCaptures)
              .catch((e) => toast(e.message, true));
          },
          classified: () => classified?.channels || [],
        });
        spectrumCid = cap.id;
        pollClassified(cap.id);
        clearInterval(classifiedTimer);
        classifiedTimer = setInterval(() => pollClassified(cap.id), 5000);
      }
      kids.push(spectrum.root);
      kids.push(el("div", { class: "spec-legend" },
        el("span", {}, "click trace to add a channel · hover for frequency"),
        el("span", { class: "right" },
          `blocks ${cap.blocksProcessed} · ${cap.blockMs} ms/block · overflow ${cap.overflowCount}`)));
      const ct = classifiedTable(cap);
      if (ct) kids.push(ct);
    } else if (spectrumCid === cap.id) {
      stopSpectrum();
    }

    const bm = bookmarkBar(cap);
    if (bm) kids.push(bm);

    const chans = cap.channels || [];
    kids.push(el("div", { style: "margin-top:10px" },
      chans.length
        ? el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "Name"), el("th", {}, "Mode"),
              el("th", {}, "Frequency"), el("th", {}, "Signal"),
              el("th", {}, "Audio"), el("th", {}, ""))),
            el("tbody", {}, chans.flatMap((ch) => channelRow(cap, ch))))
        : el("div", { class: "empty" }, "No channels — click the spectrum or Add channel"),
      el("div", { style: "margin-top:8px" },
        splitButton("+ channel", () => addChannelDlg(cap), [
          { label: "NBFM voice", onClick: () => addChannelDlg(cap, undefined, "nbfm") },
          { label: "WBFM broadcast", onClick: () => addChannelDlg(cap, undefined, "wbfm") },
          { label: "AM", onClick: () => addChannelDlg(cap, undefined, "am") },
          { label: "P25 digital", onClick: () => addChannelDlg(cap, undefined, "p25") },
        ]))));
  }

  return el("div", { class: "panel" }, kids);
}

let rootEl = null;
let unsub = null;

function render() {
  if (!rootEl) return;
  const caps = getState().captures;
  if (selectedCid === null && caps.length) selectedCid = caps[0].id;
  clear(rootEl);
  rootEl.append(
    el("div", { class: "toolbar" },
      el("h1", { style: "margin:0" }, "Monitor"),
      el("span", { class: "right" }),
      el("button", { onClick: () => {
        const cap = caps.find((c) => c.id === selectedCid);
        openBookmarkManager({
          capture: cap,
          channels: cap?.channels || [],
          onTune: (hz, mode) => cap && addChannelDlg(cap, hz, mode),
          onLoaded: refreshCaptures,
        });
      } }, "★ Bookmarks"),
      el("button", { class: "primary", onClick: createCaptureDlg }, "+ New capture")),
    caps.length
      ? el("div", {}, caps.map(capturePanel))
      : getState().loaded === false
        ? skeleton(4)  // first fetch still in flight
        : el("div", { class: "empty" },
          "No captures. Create one, or apply a recipe from the Recipes tab."),
    el("div", { class: "ticker-bar" }, messageTickerLazy()));
}

function pollVu() {
  for (const [chid, p] of players) {
    const cv = document.getElementById(`vu-${chid}`);
    if (!cv) continue;
    const ctx = cv.getContext("2d");
    ctx.fillStyle = "#121211";
    ctx.fillRect(0, 0, cv.width, cv.height);
    const lvl = Math.min(1, p.level * 3);
    ctx.fillStyle = lvl > 0.85 ? "#d95926" : "#3987e5";
    ctx.fillRect(0, 0, cv.width * lvl, cv.height);
  }
  // refresh expanded channels' message feeds
  for (const chid of expanded) fetchMessages(chid);
}

export function mountMonitor(container) {
  rootEl = container;
  unsub?.();
  unsub = subscribe((what) => {
    if (what === "captures" || what === "devices") render();
  });
  if (!streamFormats) {
    api.get("/stream/formats")
      .then((f) => { streamFormats = f.formats ?? f; })
      .catch(() => { streamFormats = ["pcm16"]; });
  }
  clearInterval(vuTimer);
  vuTimer = setInterval(pollVu, 150);
  render();
  return () => { unsub?.(); unsub = null; unmountMonitor(); rootEl = null; };
}
