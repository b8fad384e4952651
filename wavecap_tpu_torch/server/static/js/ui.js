// Tiny DOM helpers: element builder, formatting, modal, toast.

export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") node.className = v;
    else if (k === "dataset") Object.assign(node.dataset, v);
    else if (k.startsWith("on") && typeof v === "function")
      node.addEventListener(k.slice(2).toLowerCase(), v);
    else if (v !== undefined && v !== null && v !== false)
      node.setAttribute(k, v === true ? "" : v);
  }
  for (const c of children.flat()) {
    if (c === null || c === undefined || c === false) continue;
    node.append(c instanceof Node ? c : document.createTextNode(String(c)));
  }
  return node;
}

export function clear(node) {
  while (node.firstChild) node.removeChild(node.firstChild);
  return node;
}

export function fmtHz(hz) {
  if (hz === null || hz === undefined) return "—";
  const v = Number(hz);
  if (Math.abs(v) >= 1e9) return (v / 1e9).toFixed(4) + " GHz";
  if (Math.abs(v) >= 1e6) return (v / 1e6).toFixed(4) + " MHz";
  if (Math.abs(v) >= 1e3) return (v / 1e3).toFixed(1) + " kHz";
  return v.toFixed(0) + " Hz";
}

export function fmtDb(db) {
  if (db === null || db === undefined || db <= -199) return "—";
  return db.toFixed(1) + " dB";
}

export function fmtDur(s) {
  if (s === null || s === undefined) return "—";
  s = Math.round(s);
  if (s < 60) return s + "s";
  if (s < 3600) return `${Math.floor(s / 60)}m ${s % 60}s`;
  return `${Math.floor(s / 3600)}h ${Math.floor((s % 3600) / 60)}m`;
}

export function fmtTime(t) {
  if (!t) return "—";
  return new Date(t * 1000).toLocaleTimeString();
}

export function badge(state) {
  return el("span", { class: `badge ${state || ""}` }, state || "?");
}

// S-meter: sequential fill mapped -120..-20 dBFS, with dB text (not color-alone)
export function smeter(db) {
  const pct = db === null || db === undefined || db <= -199
    ? 0
    : Math.max(0, Math.min(100, ((db + 120) / 100) * 100));
  return el("span", { class: "smeter" },
    el("span", { class: "bar" },
      el("span", { class: "fill", style: `width:${pct}%` })),
    el("span", { class: "db" }, fmtDb(db)));
}

export function toast(msg, isError = false) {
  let box = document.getElementById("toasts");
  if (!box) {
    box = el("div", { id: "toasts" });
    document.body.append(box);
  }
  const t = el("div", { class: `toast ${isError ? "error" : ""}` }, msg);
  box.append(t);
  setTimeout(() => t.remove(), isError ? 7000 : 3500);
}

// modal({title, fields: [{name,label,type,value,options:[{value,label}]}], submit})
// -> Promise<object|null>
export function modal({ title, fields, submitLabel = "Create" }) {
  return new Promise((resolve) => {
    const inputs = {};
    const fieldEls = fields.map((f) => {
      let input;
      if (f.type === "select") {
        input = el("select", { name: f.name },
          ...(f.options || []).map((o) =>
            el("option", { value: o.value, selected: o.value === f.value },
              o.label ?? o.value)));
      } else if (f.type === "checkbox") {
        input = el("input", { type: "checkbox", name: f.name });
        input.checked = !!f.value;
      } else if (f.type === "textarea") {
        input = el("textarea", {
          name: f.name, rows: f.rows ?? 8,
          placeholder: f.placeholder ?? "",
        });
        input.value = f.value ?? "";
      } else {
        input = el("input", {
          type: f.type || "text", name: f.name,
          value: f.value ?? "", placeholder: f.placeholder ?? "",
          step: f.step, min: f.min, max: f.max,
        });
      }
      inputs[f.name] = input;
      return el("label", { class: "f" }, f.label, input);
    });
    const done = (result) => { back.remove(); resolve(result); };
    const back = el("div", { class: "modal-back", onClick: (e) => {
      if (e.target === back) done(null);
    } },
      el("div", { class: "modal" },
        el("h2", {}, title),
        el("div", { class: "fields" }, fieldEls),
        el("div", { class: "actions" },
          el("button", { onClick: () => done(null) }, "Cancel"),
          el("button", { class: "primary", onClick: () => {
            // per-field validation (reference wizard validation):
            // `required` and `validate(value) -> error|null` block submit
            // with an inline hint instead of a failing API round trip
            const out = {};
            let bad = false;
            for (const f of fields) {
              const inp = inputs[f.name];
              let v = f.type === "checkbox" ? inp.checked : inp.value;
              if (f.type === "number" && v !== "") v = Number(v);
              const holder = inp.closest("label");
              holder?.querySelector(".err-hint")?.remove();
              let err = null;
              if (f.required && (v === "" || v === undefined)) {
                err = "required";
              } else if (f.validate && v !== "" && v !== undefined) {
                err = f.validate(v) || null;
              }
              if (err) {
                bad = true;
                holder?.append(el("span", { class: "err-hint" }, err));
                continue;
              }
              if (v === "" && f.optional) continue;
              out[f.name] = v;
            }
            if (bad) return;
            done(out);
          } }, submitLabel))));
    document.body.append(back);
    const first = Object.values(inputs)[0];
    if (first && first.focus) first.focus();
  });
}

export function confirmDlg(text) {
  return modal({ title: text, fields: [], submitLabel: "Confirm" })
    .then((r) => r !== null);
}

// Free-form dialog: caller builds the body; returns {close} handle.
// (reference modal-dialog pattern, e.g. BookmarkManager.react.tsx)
export function dialog(title, build, { wide = false } = {}) {
  let back;
  const close = () => back.remove();
  const body = el("div", { class: "dlg-body" });
  back = el("div", { class: "modal-back", onClick: (e) => {
    if (e.target === back) close();
  } },
    el("div", { class: `modal ${wide ? "wide" : ""}` },
      el("div", { class: "dlg-head" },
        el("h2", {}, title),
        el("button", { class: "small", onClick: close }, "✕")),
      body));
  document.body.append(back);
  build(body, close);
  return { close, body };
}

// Tab strip: tabs = [{key, label}], onSelect(key) re-renders the body.
export function tabs(items, active, onSelect) {
  return el("div", { class: "tabs" }, items.map((t) =>
    el("button", {
      class: `tab ${t.key === active ? "active" : ""}`,
      onClick: () => onSelect(t.key),
    }, t.label)));
}

export function spinner(size = 16) {
  return el("span", { class: "spinner", style: `width:${size}px;height:${size}px` });
}

// Collapsible section (reference primitives/Accordion.react.tsx)
export function accordion(title, content, open = false) {
  const d = el("details", { class: "accordion" },
    el("summary", {}, title), content);
  if (open) d.open = true;
  return d;
}

// ⓘ hover tooltip (reference primitives/InfoTooltip.react.tsx)
export function infoTip(text) {
  return el("span", { class: "info-tip", title: text }, "ⓘ");
}

// Editable frequency field in MHz with arrow-key stepping
// (reference primitives/FrequencySelector.react.tsx): up/down steps by
// `stepHz` (shift = 10x, alt = 0.1x); commit on Enter/blur.
export function freqInput(valueHz, onCommit, { stepHz = 12500 } = {}) {
  const input = el("input", {
    type: "text", class: "freq-input mono",
    value: (valueHz / 1e6).toFixed(4),
  });
  const commit = () => {
    const mhz = Number(input.value);
    if (!Number.isFinite(mhz) || mhz <= 0) {
      input.value = (valueHz / 1e6).toFixed(4);
      return;
    }
    const hz = Math.round(mhz * 1e6);
    if (hz !== valueHz) { valueHz = hz; onCommit(hz); }
    input.value = (valueHz / 1e6).toFixed(4);
  };
  input.addEventListener("keydown", (e) => {
    if (e.key === "Enter") { commit(); input.blur(); }
    else if (e.key === "ArrowUp" || e.key === "ArrowDown") {
      e.preventDefault();
      const sign = e.key === "ArrowUp" ? 1 : -1;
      const step = stepHz * (e.shiftKey ? 10 : e.altKey ? 0.1 : 1);
      valueHz = Math.max(0, Math.round(valueHz + sign * step));
      input.value = (valueHz / 1e6).toFixed(4);
      onCommit(valueHz);
    }
  });
  input.addEventListener("blur", commit);
  return el("span", { class: "freq-field" }, input, el("span", { class: "unit" }, "MHz"));
}

// Volume slider bound to a ChannelPlayer-like object with .volume
// (reference primitives/VolumeSlider.react.tsx)
export function volumeSlider(player) {
  const range = el("input", {
    type: "range", min: "0", max: "1", step: "0.05",
    value: String(player.volume ?? 1), class: "vol",
    title: "Volume",
  });
  range.addEventListener("input", () => { player.volume = Number(range.value); });
  return range;
}

// Rolling audio level waveform on a canvas, fed from player.levels (a
// ring of recent RMS values) — reference primitives/AudioWaveform.react.tsx.
export function audioWaveform(player, { width = 120, height = 24 } = {}) {
  const canvas = el("canvas", { width, height, class: "wave" });
  const g = canvas.getContext("2d");
  let raf = null;
  const draw = () => {
    if (!canvas.isConnected) { cancelAnimationFrame(raf); return; }
    const levels = player.levels || [];
    g.clearRect(0, 0, width, height);
    g.fillStyle = "rgba(92, 200, 255, 0.85)";
    const n = levels.length;
    const w = Math.max(1, width / Math.max(n, 1) - 1);
    for (let i = 0; i < n; i++) {
      const h = Math.max(1, Math.min(1, levels[i] * 3) * height);
      g.fillRect(i * (w + 1), (height - h) / 2, w, h);
    }
    raf = requestAnimationFrame(draw);
  };
  raf = requestAnimationFrame(draw);
  return canvas;
}

// Loading placeholder rows (reference primitives/Skeleton.react.tsx)
export function skeleton(lines = 3, { width = "100%" } = {}) {
  return el("div", { class: "skeleton", style: `width:${width}` },
    Array.from({ length: lines }, (_, i) =>
      el("div", { class: "skel-line", style: `width:${85 - (i % 3) * 15}%` })));
}

// Status pill with semantic dot (reference primitives/StatusPill.react.tsx):
// states map to colors + the text stays visible (never color-alone)
export function statusPill(state, label) {
  const cls = {
    running: "ok", active: "ok", locked: "ok", recording: "ok",
    starting: "warn", hunting: "warn", scanning: "warn", created: "warn",
    failed: "err", error: "err", stopped: "idle", idle: "idle",
  }[String(state || "").toLowerCase()] || "idle";
  return el("span", { class: `status-pill ${cls}` },
    el("span", { class: "dot" }), label ?? state ?? "?");
}

// -/+ numeric stepper with editable value
// (reference primitives/NumericSelector.react.tsx)
export function numericSelector(value, onChange, {
  min = -Infinity, max = Infinity, step = 1, unit = "", fmt = (v) => String(v),
} = {}) {
  const input = el("input", { type: "text", class: "num-sel-value mono",
    value: fmt(value) });
  const set = (v) => {
    v = Math.max(min, Math.min(max, v));
    if (v !== value) { value = v; onChange(v); }
    input.value = fmt(value);
  };
  const commit = () => {
    const v = Number(input.value);
    if (Number.isFinite(v)) set(v); else input.value = fmt(value);
  };
  input.addEventListener("keydown", (e) => {
    if (e.key === "Enter") { commit(); input.blur(); }
    else if (e.key === "ArrowUp") { e.preventDefault(); set(value + step); }
    else if (e.key === "ArrowDown") { e.preventDefault(); set(value - step); }
  });
  input.addEventListener("blur", commit);
  return el("span", { class: "num-sel" },
    el("button", { class: "small", onClick: () => set(value - step) }, "−"),
    input,
    el("button", { class: "small", onClick: () => set(value + step) }, "+"),
    unit ? el("span", { class: "unit" }, unit) : null);
}

// Primary action + dropdown of alternatives
// (reference primitives/SplitButtonDropdown.react.tsx)
export function splitButton(label, onClick, items = []) {
  let menu = null;
  const closeMenu = () => { if (menu) { menu.remove(); menu = null; } };
  const toggle = (anchor) => {
    if (menu) { closeMenu(); return; }
    menu = el("div", { class: "split-menu" },
      items.map((it) => el("button", { class: "split-item", onClick: () => {
        closeMenu();
        it.onClick();
      } }, it.label)));
    anchor.append(menu);
    setTimeout(() => document.addEventListener("click", function onDoc(e) {
      if (menu && !menu.contains(e.target)) { closeMenu(); }
      document.removeEventListener("click", onDoc);
    }), 0);
  };
  const wrap = el("span", { class: "split-btn" },
    el("button", { class: "primary", onClick }, label),
    el("button", { class: "primary caret", title: "More options",
      onClick: (e) => { e.stopPropagation(); toggle(wrap); } }, "▾"));
  return wrap;
}
