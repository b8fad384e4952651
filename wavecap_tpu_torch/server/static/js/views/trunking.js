// Trunking view: P25 systems, control-channel status, calls, an editable
// talkgroup directory, activity summary, TSBK message log, network config
// (neighbor sites + services), live event feed and voice audio.
// Mirrors the reference frontend's trunking feature set
// (frontend/src/features/trunking/: ActiveCallsTable, ActivitySummary,
// CallEventLog, ControlChannelPanel, MessageLog, NetworkConfigPanel,
// SystemStatusPanel, TalkgroupDirectory).

import { api, openWs } from "../api.js";
import {
  el, clear, fmtHz, fmtTime, fmtDur, badge, toast, modal, confirmDlg, statusPill , infoTip } from "../ui.js";
import { getState, subscribe, refreshTrunking } from "../store.js";
import { ChannelPlayer } from "../audio.js";

let rootEl = null;
let unsub = null;
let selectedSid = null;
let eventsWs = null;
const eventLog = [];
let voicePlayer = null;
let voiceSid = null;
let recorderPlayer = null;   // per-recorder voice WS player
let recorderSid = null;      // "sid/recorderId" key
let detail = {
  calls: null, talkgroups: null, locations: null, messages: null,
  channels: null, voiceStreams: null, huntMode: "hunt", fetched: 0,
};

function stopVoice() {
  voicePlayer?.close();
  voicePlayer = null;
  voiceSid = null;
}

function stopRecorderVoice() {
  recorderPlayer?.close();
  recorderPlayer = null;
  recorderSid = null;
}

async function createSystemDlg() {
  const vals = await modal({
    title: "New trunking system",
    fields: [
      { name: "id", label: "System id", value: "sys1" },
      { name: "name", label: "Name", value: "" },
      { name: "ccs", label: "Control channels (MHz, comma-separated)",
        value: "851.2625" },
      { name: "protocol", label: "Protocol", type: "select",
        value: "p25_phase1",
        options: [
          { value: "p25_phase1", label: "P25 Phase 1 (C4FM)" },
          { value: "p25_phase2", label: "P25 Phase 2 (TDMA)" },
          { value: "dmr_tier3", label: "DMR Tier III" },
        ] },
      { name: "dmrBase", label: "DMR channel-plan base (MHz, Tier III only; blank = first CC)",
        type: "number", optional: true, value: "" },
      { name: "sampleRate", label: "Sample rate (Hz)", type: "select",
        value: "2400000",
        options: [
          { value: "960000", label: "960 kHz" },
          { value: "2400000", label: "2.4 MHz" },
          { value: "9600000", label: "9.6 MHz" },
        ] },
      { name: "huntMode", label: "Hunt mode", type: "select", value: "hunt",
        options: [
          { value: "fixed", label: "fixed — stay on the configured CC" },
          { value: "hunt", label: "hunt — cycle the list on sync loss" },
          { value: "scan", label: "scan — measure all, pick the best" },
        ] },
      { name: "modulation", label: "Phase 1 air interface", type: "select",
        value: "",
        options: [
          { value: "", label: "auto (C4FM)" },
          { value: "cqpsk", label: "CQPSK / LSM (simulcast networks)" },
        ] },
      { name: "eqTaps", label: "Simulcast equalizer taps (0 = off; odd, e.g. 127)",
        type: "number", optional: true, value: "",
        validate: (v) => v === 0 || (v > 0 && v % 2 === 1)
          ? null : "must be odd (or 0)" },
      { name: "mesh", label: "Mesh (multi-chip, e.g. stream=1,time=8; blank = single chip)",
        optional: true, value: "" },
      { name: "start", label: "Start immediately", type: "checkbox", value: true },
    ],
  });
  if (!vals) return;
  const ccs = vals.ccs.split(",").map((s) => Number(s.trim()) * 1e6)
    .filter((v) => isFinite(v) && v > 0);
  if (!ccs.length) { toast("no valid control channels", true); return; }
  try {
    await api.post("/trunking/systems", {
      id: vals.id, name: vals.name, control_channels: ccs,
      sample_rate: Number(vals.sampleRate), hunt_mode: vals.huntMode,
      protocol: vals.protocol,
      ...(vals.dmrBase !== undefined && vals.dmrBase !== ""
        ? { dmr_base_hz: vals.dmrBase * 1e6 } : {}),
      ...(vals.modulation ? { modulation: vals.modulation } : {}),
      ...(vals.eqTaps ? { equalizer_taps: vals.eqTaps } : {}),
      ...(vals.mesh ? { mesh: vals.mesh } : {}),
    });
    if (vals.start) await api.post(`/trunking/systems/${vals.id}/start`);
    toast("System created");
    refreshTrunking();
  } catch (e) { toast(e.message, true); }
}

// ---------------------------------------------------------------------------
// calls + activity
// ---------------------------------------------------------------------------

function callsTable(calls) {
  const act = calls?.active || [];
  const hist = calls?.history || [];
  return el("div", {},
    el("h2", {}, "Active calls"),
    act.length
      ? el("table", {},
          el("thead", {}, el("tr", {},
            el("th", {}, "Talkgroup"), el("th", {}, "Source"),
            el("th", {}, "Frequency"), el("th", {}, "Slot"),
            el("th", {}, "Started"))),
          el("tbody", {}, act.map((c) => el("tr", { class: "active-call" },
            el("td", {}, `${c.talkgroup || ""} (${c.tgid})`),
            el("td", { class: "mono" },
              c.sourceId ?? "—",
              c.sourceLocation
                ? el("span", { class: "muted", title: "LRRP GPS" },
                    ` 📍${c.sourceLocation.latitude?.toFixed(3)},${c.sourceLocation.longitude?.toFixed(3)}`)
                : null),
            el("td", { class: "mono" }, fmtHz(c.frequencyHz)),
            el("td", { class: "num" }, c.tdmaSlot ?? "—"),
            el("td", {}, fmtTime(c.startTime))))))
      : el("div", { class: "empty" }, "No active calls"),
    el("h2", { style: "margin-top:12px" }, "Call history"),
    hist.length
      ? el("table", {},
          el("thead", {}, el("tr", {},
            el("th", {}, "Talkgroup"), el("th", {}, "Source"),
            el("th", {}, "Frequency"), el("th", {}, "Start"),
            el("th", { class: "num" }, "Duration"),
            el("th", { class: "num" }, "Voice frames"))),
          el("tbody", {}, hist.slice(0, 40).map((c) => el("tr", {},
            el("td", {}, `${c.talkgroup || ""} (${c.tgid})`),
            el("td", { class: "mono" }, c.sourceId ?? "—"),
            el("td", { class: "mono" }, fmtHz(c.frequencyHz)),
            el("td", {}, fmtTime(c.startTime)),
            el("td", { class: "num" },
              c.durationS !== undefined ? fmtDur(c.durationS)
                : c.endTime ? fmtDur(c.endTime - c.startTime) : "—"),
            el("td", { class: "num" }, c.imbeFrames ?? 0)))))
      : el("div", { class: "empty" }, "No completed calls yet"));
}

function activitySummary(calls) {
  const hist = calls?.history || [];
  const act = calls?.active || [];
  if (!hist.length && !act.length) return null;
  const now = Date.now() / 1000;
  const recent = hist.filter((c) => now - (c.startTime || 0) < 600);
  const byTg = new Map();
  for (const c of hist) {
    const k = `${c.talkgroup || ""} (${c.tgid})`;
    const dur = c.durationS ?? (c.endTime ? c.endTime - c.startTime : 0);
    const e = byTg.get(k) || { calls: 0, airtime: 0 };
    e.calls += 1;
    e.airtime += dur || 0;
    byTg.set(k, e);
  }
  const top = [...byTg.entries()].sort((a, b) => b[1].calls - a[1].calls)
    .slice(0, 5);
  return el("div", {},
    el("h2", {}, "Activity"),
    el("div", { class: "tiles" },
      el("div", { class: "tile" },
        el("div", { class: "v" }, act.length), el("div", { class: "k" }, "Active now")),
      el("div", { class: "tile" },
        el("div", { class: "v" }, recent.length),
        el("div", { class: "k" }, "Calls / 10 min")),
      el("div", { class: "tile" },
        el("div", { class: "v" }, hist.length),
        el("div", { class: "k" }, "Total calls")),
      el("div", { class: "tile" },
        el("div", { class: "v" },
          fmtDur(hist.reduce((s, c) =>
            s + (c.durationS ?? (c.endTime ? c.endTime - c.startTime : 0) ?? 0), 0))),
        el("div", { class: "k" }, "Airtime"))),
    top.length ? el("table", { style: "margin-top:6px" },
      el("thead", {}, el("tr", {},
        el("th", {}, "Busiest talkgroups"), el("th", { class: "num" }, "Calls"),
        el("th", { class: "num" }, "Airtime"))),
      el("tbody", {}, top.map(([k, v]) => el("tr", {},
        el("td", {}, k),
        el("td", { class: "num" }, v.calls),
        el("td", { class: "num" }, fmtDur(v.airtime)))))) : null);
}

// ---------------------------------------------------------------------------
// talkgroup directory (editable)
// ---------------------------------------------------------------------------

async function editTgDlg(sid, tg) {
  const vals = await modal({
    title: tg ? `Edit TG ${tg.tgid}` : "Add talkgroup",
    fields: [
      ...(tg ? [] : [{ name: "tgid", label: "TGID", type: "number", value: "" }]),
      { name: "name", label: "Name", value: tg?.name || "" },
      { name: "category", label: "Category", value: tg?.category || "" },
      { name: "priority", label: "Priority (1 = highest)", type: "number",
        value: tg?.priority ?? 5, min: 1, max: 9 },
      { name: "record", label: "Record calls", type: "checkbox",
        value: tg ? tg.record : true },
      { name: "monitor", label: "Monitor (follow grants)", type: "checkbox",
        value: tg ? tg.monitor : true },
    ],
    submitLabel: "Save",
  });
  if (!vals) return;
  const tgid = tg ? tg.tgid : vals.tgid;
  if (!Number.isFinite(tgid)) { toast("TGID required", true); return; }
  try {
    await api.patch(`/trunking/systems/${sid}/talkgroups/${tgid}`, {
      name: vals.name, category: vals.category, priority: vals.priority,
      record: vals.record, monitor: vals.monitor,
    });
    toast("Talkgroup saved");
    detail.fetched = 0;
    render();
  } catch (e) { toast(e.message, true); }
}

async function importTgDlg(sid) {
  const vals = await modal({
    title: "Import talkgroups (RadioReference CSV)",
    fields: [{
      name: "csv", label: "CSV (Decimal, Alpha Tag, Category, Priority)",
      type: "textarea", rows: 10,
      placeholder: "Decimal,Alpha Tag,Category\n101,PD Dispatch,Police",
    }],
    submitLabel: "Import",
  });
  if (!vals || !vals.csv?.trim()) return;
  try {
    const out = await api.post(
      `/trunking/systems/${sid}/talkgroups/import`, { csv: vals.csv });
    toast(`Imported ${out.imported} talkgroups`);
    detail.fetched = 0;
    render();
  } catch (e) { toast(e.message, true); }
}

function tgTable(sid, tgs) {
  const head = el("div", { class: "toolbar", style: "margin:0 0 6px" },
    el("h2", { style: "margin:0" }, "Talkgroups"),
    el("span", { class: "spacer" }),
    el("button", { class: "small", onClick: () => editTgDlg(sid, null) }, "+ Add"),
    el("button", { class: "small", onClick: () => importTgDlg(sid) }, "Import CSV"));
  if (!tgs?.length)
    return el("div", {}, head,
      el("div", { class: "empty" }, "No talkgroups configured — unknown TGs are recorded by default"));
  return el("div", {}, head,
    el("table", {},
      el("thead", {}, el("tr", {},
        el("th", {}, "TGID"), el("th", {}, "Name"), el("th", {}, "Category"),
        el("th", { class: "num" }, "Priority"), el("th", {}, "Record"),
        el("th", {}, "Monitor"), el("th", {}, ""))),
      el("tbody", {}, tgs.map((t) => el("tr", {},
        el("td", { class: "mono" }, t.tgid),
        el("td", {}, t.name),
        el("td", {}, t.category || "—"),
        el("td", { class: "num" }, t.priority),
        el("td", {}, t.record ? "✓" : "—"),
        el("td", {}, t.monitor ? "✓" : "—"),
        el("td", {}, el("button", { class: "small",
          onClick: () => editTgDlg(sid, t) }, "Edit")))))));
}

function locTable(locs) {
  if (!locs?.length) return el("div", { class: "empty" }, "No GPS reports (LRRP)");
  return el("table", {},
    el("thead", {}, el("tr", {},
      el("th", {}, "Unit"), el("th", {}, "Latitude"), el("th", {}, "Longitude"),
      el("th", { class: "num" }, "Speed km/h"), el("th", {}, "Time"))),
    el("tbody", {}, locs.map((l) => el("tr", {},
      el("td", { class: "mono" }, l.unitId),
      el("td", { class: "mono" }, l.latitude?.toFixed(5)),
      el("td", { class: "mono" }, l.longitude?.toFixed(5)),
      el("td", { class: "num" }, l.speedKmh?.toFixed(0) ?? "—"),
      el("td", {}, fmtTime(l.time))))));
}

// ---------------------------------------------------------------------------
// message log + network config
// ---------------------------------------------------------------------------

function msgSummary(m) {
  const skip = new Set(["time", "type", "nac", "crc_ok", "mfid", "opcode"]);
  const parts = [];
  for (const [k, v] of Object.entries(m)) {
    if (skip.has(k) || v === null || v === undefined) continue;
    parts.push(`${k}=${typeof v === "number" && k.includes("frequency")
      ? fmtHz(v) : JSON.stringify(v)}`);
    if (parts.length >= 5) break;
  }
  return parts.join(" ");
}

function messageLog(messages) {
  if (!messages?.length)
    return el("div", { class: "empty" }, "No control-channel messages yet");
  return el("table", { class: "msglog" },
    el("thead", {}, el("tr", {},
      el("th", {}, "Time"), el("th", {}, "Type"), el("th", {}, "Fields"))),
    el("tbody", {}, messages.slice(-60).reverse().map((m) => el("tr", {},
      el("td", { class: "mono" }, fmtTime(m.time)),
      el("td", { class: "mono" }, m.type),
      el("td", { class: "mono muted", style: "font-size:11px" },
        msgSummary(m))))));
}

function networkPanel(sys) {
  const adj = sys.adjacentSites || [];
  const svc = sys.services;
  const idens = Object.entries(sys.identifiers || {});
  return el("div", {},
    el("h2", {}, "Network"),
    adj.length
      ? el("table", {},
          el("thead", {}, el("tr", {},
            el("th", {}, "System"), el("th", {}, "RFSS"), el("th", {}, "Site"),
            el("th", {}, "Frequency"), el("th", {}, "Seen"))),
          el("tbody", {}, adj.map((a) => el("tr", {},
            el("td", { class: "mono" }, a.systemId ?? "—"),
            el("td", { class: "num" }, a.rfssId),
            el("td", { class: "num" }, a.siteId),
            el("td", { class: "mono" }, fmtHz(a.frequencyHz)),
            el("td", {}, fmtTime(a.lastSeen))))))
      : el("div", { class: "empty" }, "No adjacent sites announced"),
    idens.length ? el("div", { style: "margin-top:8px" },
      el("h2", {}, "Channel identifiers"),
      el("table", {},
        el("thead", {}, el("tr", {},
          el("th", {}, "Iden"), el("th", {}, "Base"), el("th", {}, "Spacing"),
          el("th", {}, "Offset"), el("th", { class: "num" }, "TDMA slots"))),
        el("tbody", {}, idens.map(([id, v]) => el("tr", {},
          el("td", { class: "num" }, id),
          el("td", { class: "mono" }, fmtHz(v.base_hz ?? v.baseHz)),
          el("td", { class: "mono" }, fmtHz(v.spacing_hz ?? v.spacingHz)),
          el("td", { class: "mono" }, fmtHz(v.tx_offset_hz ?? v.txOffsetHz)),
          el("td", { class: "num" }, v.slots_per_carrier ?? v.slotsPerCarrier ?? 1)))))) : null,
    svc ? el("div", { style: "margin-top:8px" },
      el("h2", {}, "System services"),
      el("div", { class: "mono sec", style: "font-size:12px" },
        msgSummary(svc))) : null);
}

function ccPanel(sys) {
  const chans = detail.channels || [];
  const maxP = Math.max(...chans.map((m) => m.powerDb ?? -120), -119);
  const huntSel = el("select", {
    onChange: (e) => {
      api.patch(`/trunking/systems/${sys.id}/hunt-mode`,
        { huntMode: e.target.value })
        .then(() => toast(`Hunt mode: ${e.target.value}`))
        .catch((er) => toast(er.message, true));
    } },
    ...["fixed", "hunt", "scan"].map((m) =>
      el("option", { value: m, selected: m === detail.huntMode }, m)));
  return el("div", {},
    el("div", { class: "toolbar", style: "margin:0 0 6px" },
      el("h2", { style: "margin:0" }, "Control channels",
        el("span", { class: "muted", style: "font-size:11px; margin-left:8px" },
          "power + SNR + sync-verified; +6 dB better roams while locked")),
      el("span", { class: "spacer" }),
      el("label", { class: "inline", style: "font-size:12px" },
        "hunt ", huntSel),
      el("button", { class: "small", title: "re-verify all candidates",
        onClick: () => api.post(`/trunking/systems/${sys.id}/scan`)
          .then(() => { toast("Scan triggered"); detail.fetched = 0; render(); })
          .catch((er) => toast(er.message, true)) }, "Scan")),
    chans.length
      ? el("table", {},
          el("thead", {}, el("tr", {},
            el("th", {}, "Frequency"), el("th", {}, "Signal"),
            el("th", { class: "num" }, "SNR"), el("th", {}, "Sync"),
            el("th", {}, ""))),
          el("tbody", {}, chans.map((m) => {
            const p = m.powerDb;
            const pct = p === undefined || p === null
              ? 0 : Math.max(4, Math.min(100, (p + 120) / (maxP + 125) * 100));
            return el("tr", { class: m.enabled ? "" : "muted" },
              el("td", { class: "mono" },
                fmtHz(m.frequencyHz),
                m.current ? el("span", { class: "badge locked",
                  style: "margin-left:6px" }, "current") : null,
                m.locked ? el("span", { class: "badge",
                  style: "margin-left:6px" }, "pinned") : null),
              el("td", {}, el("span", { class: "smeter" },
                el("span", { class: "bar" },
                  el("span", { class: "fill", style: `width:${pct}%` })),
                el("span", { class: "db" },
                  p?.toFixed?.(1) !== undefined ? `${p.toFixed(1)} dB` : "—"))),
              el("td", { class: "num" }, m.snrDb?.toFixed?.(1) ?? "—"),
              el("td", {},
                m.syncDetected ? `✓ ${m.crcOk ?? 0} crc` : "—"),
              el("td", {},
                el("button", { class: "small",
                  title: m.enabled ? "exclude from hunting" : "re-enable",
                  onClick: () => api.patch(
                    `/trunking/systems/${sys.id}/channels/${m.frequencyHz}/enabled`,
                    { enabled: !m.enabled })
                    .then(() => { detail.fetched = 0; render(); })
                    .catch((er) => toast(er.message, true)),
                }, m.enabled ? "disable" : "enable"),
                " ",
                el("button", { class: "small",
                  title: "pin hunting to this frequency",
                  onClick: () => api.post(
                    `/trunking/systems/${sys.id}/channels/${m.frequencyHz}/lock`,
                    { locked: !m.locked })
                    .then(() => { detail.fetched = 0; render(); })
                    .catch((er) => toast(er.message, true)),
                }, m.locked ? "unpin" : "pin")));
          })))
      : el("div", { class: "empty" }, "No measurements yet"));
}

function recordingsTable(sys) {
  const recs = detail.recordings || [];
  if (!recs.length) return null;
  return el("div", { style: "margin-top:8px" },
    el("h2", {}, "Recorded calls"),
    el("table", {},
      el("thead", {}, el("tr", {},
        el("th", {}, "Time"), el("th", {}, "Talkgroup"),
        el("th", {}, "Source"), el("th", { class: "num" }, "Audio"),
        el("th", {}, "Play"))),
      el("tbody", {}, recs.slice(0, 25).map((m) => el("tr", {},
        el("td", {}, fmtTime(m.startTime)),
        el("td", {}, `${m.talkgroup || ""} (${m.tgid})`),
        el("td", { class: "mono" }, m.sourceId ?? "—"),
        el("td", { class: "num" },
          m.audioSeconds ? fmtDur(m.audioSeconds) : "—"),
        el("td", {}, m.hasAudio
          ? el("audio", { controls: true, preload: "none",
              style: "height:24px; max-width:220px",
              src: `/api/v1/trunking/systems/${sys.id}/recordings/${m.name}.wav` })
          : el("span", { class: "muted" }, "codewords only")))))));
}

function voiceStreamsTable(sys) {
  const vs = detail.voiceStreams || [];
  if (!vs.length) return null;
  return el("div", { style: "margin-top:8px" },
    el("h2", {}, "Voice recorders"),
    el("table", {},
      el("thead", {}, el("tr", {},
        el("th", {}, "Recorder"), el("th", {}, "State"),
        el("th", {}, "Talkgroup"), el("th", {}, "Frequency"),
        el("th", {}, "Started"), el("th", {}, ""))),
      el("tbody", {}, vs.map((v) => {
        const key = `${sys.id}/${v.recorderId}`;
        const on = recorderSid === key;
        return el("tr", {},
          el("td", { class: "mono" }, `#${v.recorderId} (${v.channelId})`),
          el("td", {}, statusPill(v.state)),
          el("td", {}, v.tgid ? `${v.talkgroup || ""} (${v.tgid})` : "—"),
          el("td", { class: "mono" }, v.frequencyHz ? fmtHz(v.frequencyHz) : "—"),
          el("td", {}, v.startTime ? fmtTime(v.startTime) : "—"),
          el("td", {}, el("button", {
            class: `small ${on ? "primary" : ""}`,
            title: "Listen to this recorder only (per-recorder voice WS)",
            onClick: () => {
              stopRecorderVoice();
              if (!on) {
                recorderPlayer = new ChannelPlayer(
                  `/trunking/stream/${sys.id}/voice/${v.recorderId}`,
                  { rate: 8000 });
                recorderSid = key;
              }
              render();
            },
          }, on ? "■" : "▶")));
      }))));
}

// ---------------------------------------------------------------------------

function systemDetail(sys) {
  const tiles = el("div", { class: "tiles" },
    el("div", { class: "tile" },
      el("div", { class: "v" }, fmtHz(sys.controlChannelHz),
        " ", infoTip("Hunt modes - fixed: stay on the configured control "
          + "channel; hunt: cycle the candidate list on sync loss "
          + "(includes learned adjacent sites); scan: measure all and "
          + "pick the best by SNR + sync verification.")),
      el("div", { class: "k" }, "Control channel")),
    el("div", { class: "tile" },
      el("div", { class: "v" }, sys.synced ? "Locked" : "Hunting"),
      el("div", { class: "k" }, "CC sync")),
    el("div", { class: "tile" },
      el("div", { class: "v mono" },
        sys.nac !== null && sys.nac !== undefined
          ? "0x" + sys.nac.toString(16).toUpperCase() : "—"),
      el("div", { class: "k" }, "NAC")),
    el("div", { class: "tile" },
      el("div", { class: "v mono" }, sys.systemId ?? "—"),
      el("div", { class: "k" }, "System")),
    el("div", { class: "tile" },
      el("div", { class: "v mono" },
        `${sys.rfssId ?? "—"}/${sys.siteId ?? "—"}`),
      el("div", { class: "k" }, "RFSS / site")),
    el("div", { class: "tile" },
      el("div", { class: "v" }, sys.tsbkCount ?? 0),
      el("div", { class: "k" }, "TSBKs")),
    el("div", { class: "tile" },
      el("div", { class: "v" },
        `${((sys.tsbkCrcRate ?? 0) * 100).toFixed(1)}%`),
      el("div", { class: "k" }, "CRC pass")));

  const voiceOn = voiceSid === sys.id;
  const voiceBtn = el("button", {
    class: `small ${voiceOn ? "primary" : ""}`,
    onClick: () => {
      if (voiceOn) stopVoice();
      else {
        stopVoice();
        voicePlayer = new ChannelPlayer(`/trunking/stream/${sys.id}/voice`,
          { rate: 8000 });
        voiceSid = sys.id;
      }
      render();
    },
  }, voiceOn ? "■ Voice on (stop)" : "▶ Listen to calls");

  return el("div", {},
    tiles,
    el("div", { style: "margin-bottom:12px" }, voiceBtn),
    el("div", { class: "row" },
      el("div", { class: "panel" },
        activitySummary(detail.calls),
        callsTable(detail.calls),
        recordingsTable(sys)),
      el("div", { class: "panel" },
        tgTable(sys.id, detail.talkgroups),
        el("h2", { style: "margin-top:12px" }, "Locations"),
        locTable(detail.locations))),
    el("div", { class: "row" },
      el("div", { class: "panel" },
        ccPanel(sys), voiceStreamsTable(sys), networkPanel(sys)),
      el("div", { class: "panel" },
        el("h2", {}, "Control-channel messages"),
        el("div", { style: "max-height:300px; overflow-y:auto" },
          messageLog(detail.messages)),
        el("h2", { style: "margin-top:12px" }, "Event feed"),
        el("div", { class: "logbox", id: "tk-events" },
          eventLog.slice(-200).map((e) =>
            `${fmtTime(e.time)}  ${e.type ?? ""}  ${JSON.stringify(e)}`)
            .join("\n")))));
}

async function fetchDetail(sid) {
  const now = Date.now();
  if (now - detail.fetched < 2000) return;
  detail.fetched = now;
  try {
    const [calls, tgs, locs, msgs, chans, vstreams, hunt, recs] =
      await Promise.all([
        api.get(`/trunking/systems/${sid}/calls`),
        api.get(`/trunking/systems/${sid}/talkgroups`),
        api.get(`/trunking/systems/${sid}/locations`),
        api.get(`/trunking/systems/${sid}/messages?limit=60`),
        api.get(`/trunking/systems/${sid}/channels`),
        api.get(`/trunking/systems/${sid}/voice-streams`),
        api.get(`/trunking/systems/${sid}/hunt-mode`),
        api.get(`/trunking/systems/${sid}/recordings?limit=25`),
      ]);
    detail.calls = calls;
    detail.talkgroups = tgs;
    detail.locations = locs;
    detail.messages = msgs;
    detail.channels = chans;
    detail.voiceStreams = vstreams;
    detail.huntMode = hunt.huntMode;
    detail.recordings = recs;
    render();
  } catch { /* system may be starting */ }
}

function render() {
  if (!rootEl) return;
  const systems = getState().trunking;
  if (selectedSid === null && systems.length) selectedSid = systems[0].id;
  const sel = systems.find((s) => s.id === selectedSid);
  clear(rootEl);
  rootEl.append(
    el("div", { class: "toolbar" },
      el("h1", { style: "margin:0" }, "Trunking"),
      el("span", { class: "right" }),
      el("button", { class: "primary", onClick: createSystemDlg }, "+ New system")),
    systems.length
      ? el("div", { class: "panel" },
          el("table", {},
            el("thead", {}, el("tr", {},
              el("th", {}, "System"), el("th", {}, "State"),
              el("th", {}, "Protocol"), el("th", {}, "Control"),
              el("th", {}, "Sync"), el("th", {}, ""))),
            el("tbody", {}, systems.map((s) => el("tr", {
              class: "clickable",
              style: s.id === selectedSid ? "outline:1px solid var(--accent)" : "",
              onClick: () => { selectedSid = s.id; detail.fetched = 0; render(); },
            },
              el("td", {}, s.name || s.id),
              el("td", {}, statusPill(s.state)),
              el("td", {}, s.protocol),
              el("td", { class: "mono" }, fmtHz(s.controlChannelHz)),
              el("td", {}, s.synced ? statusPill("locked") : statusPill("hunting")),
              el("td", {},
                s.state === "running"
                  ? el("button", { class: "small", onClick: (e) => {
                      e.stopPropagation();
                      api.post(`/trunking/systems/${s.id}/stop`).then(refreshTrunking);
                    } }, "Stop")
                  : el("button", { class: "small primary", onClick: (e) => {
                      e.stopPropagation();
                      api.post(`/trunking/systems/${s.id}/start`)
                        .then(refreshTrunking).catch((er) => toast(er.message, true));
                    } }, "Start"),
                " ",
                el("button", { class: "small danger", onClick: async (e) => {
                  e.stopPropagation();
                  if (!(await confirmDlg(`Delete system ${s.id}?`))) return;
                  if (voiceSid === s.id) stopVoice();
                  await api.del(`/trunking/systems/${s.id}`)
                    .catch((er) => toast(er.message, true));
                  selectedSid = null;
                  refreshTrunking();
                } }, "✕")))))))
      : el("div", { class: "empty" },
          "No trunking systems. Create one or apply a P25 recipe."),
    sel ? systemDetail(sel) : null);
  if (sel) fetchDetail(sel.id);
}

export function mountTrunking(container) {
  rootEl = container;
  unsub?.();
  unsub = subscribe((what) => {
    if (what === "trunking") render();
  });
  if (!eventsWs) {
    eventsWs = openWs("/trunking/stream", {
      json: (evt) => {
        eventLog.push(evt);
        if (eventLog.length > 500) eventLog.splice(0, eventLog.length - 500);
        const box = document.getElementById("tk-events");
        if (box) {
          box.textContent += "\n" +
            `${fmtTime(evt.time)}  ${evt.type ?? ""}  ${JSON.stringify(evt)}`;
          box.scrollTop = box.scrollHeight;
        }
      },
    });
  }
  render();
  return () => {
    unsub?.(); unsub = null;
    rootEl = null;
    // keep events WS + voice running across tab switches
  };
}
