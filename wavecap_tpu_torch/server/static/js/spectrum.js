// Spectrum analyzer + waterfall on <canvas>, fed by the spectrum WS.
// Mirrors the reference frontend's SpectrumAnalyzer/WaterfallDisplay/
// ChannelClassifierBar primitives (frontend/src/components/primitives/):
// peak hold, trace averaging, pause, wheel zoom + pan, frequency/dB axes,
// drag-to-retune channel markers, classified-signal strip.
//
// Colormap: single-hue sequential (the palette's blue ramp, dark surface):
// near-noise-floor recedes to the surface, strong signal brightens —
// magnitude is one hue light->dark per the color formula.

import { openWs } from "./api.js";
import { el, clear, fmtHz } from "./ui.js";

// blue sequential ramp, surface -> step700 -> ... -> step100 (bright = hot)
const RAMP = [
  "#121211", "#0d366b", "#104281", "#184f95", "#1c5cab", "#256abf",
  "#2a78d6", "#3987e5", "#5598e7", "#6da7ec", "#86b6ef", "#9ec5f4",
  "#b7d3f6", "#cde2fb",
];

function buildLut() {
  const lut = new Uint8Array(256 * 3);
  const stops = RAMP.map((h) => [
    parseInt(h.slice(1, 3), 16),
    parseInt(h.slice(3, 5), 16),
    parseInt(h.slice(5, 7), 16),
  ]);
  for (let i = 0; i < 256; i++) {
    const t = (i / 255) * (stops.length - 1);
    const a = Math.floor(t), b = Math.min(a + 1, stops.length - 1);
    const f = t - a;
    for (let c = 0; c < 3; c++)
      lut[i * 3 + c] = Math.round(stops[a][c] * (1 - f) + stops[b][c] * f);
  }
  return lut;
}
const LUT = buildLut();

const SPEC_H = 170;
const FALL_H = 220;
const CLASS_H = 10;
const AXIS_H = 14;

const KIND_COLOR = {
  control: "#d95926", voice: "#3987e5", data: "#8a897f",
};

export class SpectrumView {
  /**
   * opts: {
   *   onTune(freqHz),
   *   markers: () => [{id, freqHz, name, color}],
   *   onMarkerDrag(id, freqHz),          // retune by dragging a marker
   *   classified: () => [{frequency_hz, kind, occupancy}],
   * }
   */
  constructor(captureId, opts = {}) {
    this.opts = opts;
    this.centerHz = 0;
    this.sampleRate = 1;
    this.dbMin = -110;
    this.dbMax = -20;
    this.zoom = 1;          // 1..32 view magnification
    this.viewCenter = 0.5;  // center of the view window, fraction of span
    this.paused = false;
    this.peakHold = false;
    this.averaging = false;
    this._peak = null;
    this._avg = null;
    this._lastDb = null;
    this._drag = null;      // {id, x} while dragging a marker

    this.spec = el("canvas", { height: SPEC_H + AXIS_H, class: "clickable" });
    this.strip = el("canvas", { height: CLASS_H, title: "classified signals" });
    this.fall = el("canvas", { height: FALL_H, class: "clickable" });
    this.label = null;
    this.toolbar = this._buildToolbar();
    this.root = el("div", { class: "spectrum-wrap" },
      this.toolbar, this.spec, this.strip, this.fall);
    this.root.style.display = "flex";
    this.root.style.flexDirection = "column";
    this.root.style.gap = "2px";

    const hover = (e) => this._hover(e);
    const leave = () => { this.label?.remove(); this.label = null; };
    const click = (e) => {
      if (this._suppressClick) { this._suppressClick = false; return; }
      const hz = this._freqAt(e);
      if (hz !== null && this.opts.onTune) this.opts.onTune(hz);
    };
    for (const cv of [this.spec, this.fall]) {
      cv.addEventListener("mousemove", hover);
      cv.addEventListener("mouseleave", leave);
      cv.addEventListener("click", click);
      cv.addEventListener("wheel", (e) => this._wheel(e), { passive: false });
      cv.addEventListener("dblclick", () => {
        this.zoom = 1; this.viewCenter = 0.5; this._updateZoomLabel();
        this._redraw();
      });
    }
    this.spec.addEventListener("mousedown", (e) => this._dragStart(e));
    window.addEventListener("mousemove", this._dragMove = (e) => this._dragTo(e));
    window.addEventListener("mouseup", this._dragEnd = (e) => this._dragStop(e));

    this.ws = openWs(`/stream/captures/${captureId}/spectrum`, {
      json: (msg) => { if (msg.type === "spectrum") this._frame(msg); },
    });
  }

  _buildToolbar() {
    const btn = (label, title, onClick) =>
      el("button", { class: "small spec-btn", title, onClick }, label);
    this._pauseBtn = btn("⏸", "pause/resume", () => {
      this.paused = !this.paused;
      this._pauseBtn.classList.toggle("primary", this.paused);
      this._pauseBtn.textContent = this.paused ? "▶" : "⏸";
    });
    this._peakBtn = btn("peak", "peak hold trace", () => {
      this.peakHold = !this.peakHold;
      this._peak = null;
      this._peakBtn.classList.toggle("primary", this.peakHold);
    });
    this._avgBtn = btn("avg", "exponential trace averaging", () => {
      this.averaging = !this.averaging;
      this._avg = null;
      this._avgBtn.classList.toggle("primary", this.averaging);
    });
    this._zoomLabel = el("span", { class: "muted mono", style: "font-size:11px" },
      "1×");
    return el("div", { class: "spec-toolbar" },
      this._pauseBtn, this._peakBtn, this._avgBtn,
      el("span", { class: "muted", style: "font-size:11px" },
        "wheel: zoom · dbl-click: reset · drag marker: retune"),
      el("span", { class: "spacer" }),
      this._zoomLabel);
  }

  _updateZoomLabel() {
    this._zoomLabel.textContent = `${this.zoom}×`;
  }

  // view window [v0, v1) as fractions of the full span
  _view() {
    const w = 1 / this.zoom;
    let c = this.viewCenter;
    c = Math.max(w / 2, Math.min(1 - w / 2, c));
    this.viewCenter = c;
    return [c - w / 2, c + w / 2];
  }

  _fracAt(e) {
    const cv = e.target.tagName === "CANVAS" ? e.target : this.spec;
    const rect = cv.getBoundingClientRect();
    const x = (e.clientX - rect.left) / rect.width;
    if (x < 0 || x > 1) return null;
    const [v0, v1] = this._view();
    return v0 + x * (v1 - v0);
  }

  _freqAt(e) {
    const frac = this._fracAt(e);
    if (frac === null || !this.sampleRate) return null;
    return this.centerHz + (frac - 0.5) * this.sampleRate;
  }

  _xOf(freqHz, w) {
    const [v0, v1] = this._view();
    const frac = (freqHz - this.centerHz) / this.sampleRate + 0.5;
    return ((frac - v0) / (v1 - v0)) * w;
  }

  _wheel(e) {
    e.preventDefault();
    const frac = this._fracAt(e);
    if (frac === null) return;
    const old = this.zoom;
    this.zoom = e.deltaY < 0
      ? Math.min(32, this.zoom * 2)
      : Math.max(1, this.zoom / 2);
    if (this.zoom !== old) {
      // keep the frequency under the cursor stationary
      const rect = (e.target).getBoundingClientRect();
      const x = (e.clientX - rect.left) / rect.width;
      this.viewCenter = frac - (x - 0.5) / this.zoom;
      this._updateZoomLabel();
      this._redraw();
    }
  }

  _markerNear(e) {
    const rect = this.spec.getBoundingClientRect();
    const px = e.clientX - rect.left;
    const w = this.spec.width;
    const scale = w / rect.width;
    const markers = this.opts.markers ? this.opts.markers() : [];
    for (const m of markers) {
      if (m.id === undefined) continue;
      const mx = this._xOf(m.freqHz, w) / scale;
      if (Math.abs(mx - px) < 6) return m;
    }
    return null;
  }

  _dragStart(e) {
    if (!this.opts.onMarkerDrag) return;
    const m = this._markerNear(e);
    if (m) {
      this._drag = { id: m.id, name: m.name, hz: m.freqHz };
      e.preventDefault();
    }
  }

  _dragTo(e) {
    if (!this._drag) return;
    const hz = this._freqAt({ target: this.spec, clientX: e.clientX });
    if (hz !== null) {
      this._drag.hz = hz;
      this._redraw();
    }
  }

  _dragStop(e) {
    if (!this._drag) return;
    const d = this._drag;
    this._drag = null;
    this._suppressClick = true;
    const hz = this._freqAt({ target: this.spec, clientX: e.clientX });
    if (hz !== null && this.opts.onMarkerDrag) this.opts.onMarkerDrag(d.id, hz);
  }

  _hover(e) {
    const hz = this._freqAt(e);
    if (hz === null) return;
    if (!this.label) {
      this.label = el("span", { class: "freq-label" });
      this.root.append(this.label);
    }
    const rect = this.root.getBoundingClientRect();
    const db = this._dbAtFreq(hz);
    this.label.textContent = db === null ? fmtHz(hz)
      : `${fmtHz(hz)} · ${db.toFixed(1)} dB`;
    this.label.style.left = `${e.clientX - rect.left}px`;
    this.label.style.top = `${e.clientY - rect.top - 28}px`;
    this.spec.style.cursor = this._markerNear(e) ? "ew-resize" : "crosshair";
  }

  _dbAtFreq(hz) {
    const db = this._lastDb;
    if (!db || !this.sampleRate) return null;
    const frac = (hz - this.centerHz) / this.sampleRate + 0.5;
    const i = Math.round(frac * (db.length - 1));
    if (i < 0 || i >= db.length) return null;
    return db[i];
  }

  _frame(msg) {
    this.centerHz = msg.centerHz;
    this.sampleRate = msg.sampleRate;
    if (this.paused) return;
    let db = msg.db;
    const n = db.length;
    if (this.averaging) {
      if (!this._avg || this._avg.length !== n) this._avg = db.slice();
      else for (let i = 0; i < n; i++)
        this._avg[i] += (db[i] - this._avg[i]) * 0.25;
      db = this._avg;
    }
    if (this.peakHold) {
      if (!this._peak || this._peak.length !== n) this._peak = db.slice();
      else for (let i = 0; i < n; i++) {
        this._peak[i] = Math.max(this._peak[i] - 0.15, db[i]); // slow decay
      }
    }
    this._lastDb = db;
    const wCss = this.root.clientWidth || 640;
    if (this.spec.width !== wCss) {
      this.spec.width = wCss;
      this.fall.width = wCss;
      this.strip.width = wCss;
      this._fallCtx = null;
    }
    // autorange with slow decay
    let lo = Infinity, hi = -Infinity;
    for (const v of db) { if (v < lo) lo = v; if (v > hi) hi = v; }
    if (isFinite(lo)) {
      this.dbMin += (lo - 4 - this.dbMin) * 0.08;
      this.dbMax += (hi + 8 - this.dbMax) * 0.08;
    }
    this._redraw();
    this._drawFall(db, n);
  }

  _redraw() {
    if (this._lastDb) {
      this._drawSpec(this._lastDb, this._lastDb.length);
      this._drawStrip();
    }
  }

  // index range of the view window into an n-bin array
  _binRange(n) {
    const [v0, v1] = this._view();
    return [v0 * (n - 1), v1 * (n - 1)];
  }

  _drawSpec(db, n) {
    const ctx = this.spec.getContext("2d");
    const w = this.spec.width, h = SPEC_H;
    const css = getComputedStyle(document.documentElement);
    ctx.fillStyle = css.getPropertyValue("--surface-0").trim() || "#121211";
    ctx.fillRect(0, 0, w, h + AXIS_H);

    const y = (v) =>
      h - ((v - this.dbMin) / Math.max(this.dbMax - this.dbMin, 1)) * (h - 8) - 4;

    // recessive grid: horizontal dB lines every 20 dB
    ctx.strokeStyle = "rgba(195,194,183,0.12)";
    ctx.fillStyle = "rgba(138,137,127,0.85)";
    ctx.font = "10px monospace";
    ctx.lineWidth = 1;
    const start = Math.ceil(this.dbMin / 20) * 20;
    for (let g = start; g < this.dbMax; g += 20) {
      const gy = y(g);
      ctx.beginPath();
      ctx.moveTo(0, gy);
      ctx.lineTo(w, gy);
      ctx.stroke();
      ctx.fillText(`${g.toFixed(0)}`, 4, gy - 2);
    }

    // frequency axis: ~6 ticks at a round step
    const [v0, v1] = this._view();
    const f0 = this.centerHz + (v0 - 0.5) * this.sampleRate;
    const f1 = this.centerHz + (v1 - 0.5) * this.sampleRate;
    const span = f1 - f0;
    if (span > 0) {
      const rawStep = span / 6;
      const mag = Math.pow(10, Math.floor(Math.log10(rawStep)));
      const step = [1, 2, 2.5, 5, 10].map((m) => m * mag)
        .find((s) => s >= rawStep) || 10 * mag;
      ctx.strokeStyle = "rgba(195,194,183,0.10)";
      ctx.fillStyle = "rgba(138,137,127,0.9)";
      for (let f = Math.ceil(f0 / step) * step; f <= f1; f += step) {
        const x = this._xOf(f, w);
        ctx.beginPath();
        ctx.moveTo(x, 0);
        ctx.lineTo(x, h);
        ctx.stroke();
        const txt = span >= 5e6
          ? `${(f / 1e6).toFixed(1)}M`
          : span >= 1e5
            ? `${(f / 1e6).toFixed(3)}M`
            : `${(f / 1e3).toFixed(1)}k`;
        ctx.fillText(txt, Math.min(Math.max(x - 14, 2), w - 40), h + AXIS_H - 3);
      }
    }

    // channel markers under the trace
    const markers = this.opts.markers ? this.opts.markers() : [];
    for (const m of markers) {
      const dragging = this._drag && this._drag.id === m.id;
      const fhz = dragging ? this._drag.hz : m.freqHz;
      const x = this._xOf(fhz, w);
      if (x < 0 || x > w) continue;
      ctx.strokeStyle = dragging
        ? "rgba(217,89,38,1.0)" : "rgba(217,89,38,0.65)"; // series-2 orange
      ctx.lineWidth = dragging ? 2 : 1;
      ctx.beginPath();
      ctx.moveTo(x, 0);
      ctx.lineTo(x, h);
      ctx.stroke();
      if (m.name) {
        ctx.fillStyle = "rgba(217,89,38,0.9)";
        ctx.fillText(
          (dragging ? `${m.name} → ${fmtHz(fhz)}` : m.name).slice(0, 28),
          Math.min(x + 3, w - 60), 12);
      }
    }
    ctx.lineWidth = 1;

    const [b0, b1] = this._binRange(n);
    const binToX = (i) => ((i - b0) / Math.max(b1 - b0, 1)) * w;

    // peak-hold: thin bright line above the trace
    if (this.peakHold && this._peak) {
      ctx.strokeStyle = "#cde2fb";
      ctx.lineWidth = 1;
      ctx.beginPath();
      for (let i = Math.max(0, Math.floor(b0)); i <= Math.min(n - 1, Math.ceil(b1)); i++) {
        const x = binToX(i), yy = y(this._peak[i]);
        if (i === Math.max(0, Math.floor(b0))) ctx.moveTo(x, yy);
        else ctx.lineTo(x, yy);
      }
      ctx.stroke();
    }

    // trace: 2px line, series blue
    ctx.strokeStyle = "#3987e5";
    ctx.lineWidth = 2;
    ctx.beginPath();
    let first = true;
    for (let i = Math.max(0, Math.floor(b0)); i <= Math.min(n - 1, Math.ceil(b1)); i++) {
      const x = binToX(i);
      const yy = y(db[i]);
      if (first) { ctx.moveTo(x, yy); first = false; }
      else ctx.lineTo(x, yy);
    }
    ctx.stroke();
  }

  _drawStrip() {
    const ctx = this.strip.getContext("2d");
    const w = this.strip.width;
    ctx.fillStyle = "#121211";
    ctx.fillRect(0, 0, w, CLASS_H);
    const found = this.opts.classified ? this.opts.classified() : [];
    if (!found || !found.length) return;
    for (const c of found) {
      const hz = c.frequency_hz ?? c.frequencyHz;
      const x = this._xOf(hz, w);
      if (x < 0 || x > w) continue;
      ctx.fillStyle = KIND_COLOR[c.kind] || "#8a897f";
      const bw = Math.max(3, (12500 / this.sampleRate) * this.zoom * w);
      ctx.globalAlpha = 0.4 + 0.6 * Math.min(1, c.occupancy ?? 1);
      ctx.fillRect(x - bw / 2, 1, bw, CLASS_H - 2);
    }
    ctx.globalAlpha = 1;
  }

  _drawFall(db, n) {
    const ctx = this.fall.getContext("2d");
    const w = this.fall.width, h = this.fall.height;
    if (!this._fallCtx) {
      ctx.fillStyle = "#121211";
      ctx.fillRect(0, 0, w, h);
      this._fallCtx = ctx;
      this._row = ctx.createImageData(w, 1);
    }
    // scroll down 1px
    ctx.drawImage(this.fall, 0, 0, w, h - 1, 0, 1, w, h - 1);
    const row = this._row;
    const span = Math.max(this.dbMax - this.dbMin, 1);
    const [b0, b1] = this._binRange(n);
    for (let x = 0; x < w; x++) {
      const i = Math.max(0, Math.min(n - 1,
        Math.round(b0 + (x / (w - 1)) * (b1 - b0))));
      let t = (db[i] - this.dbMin) / span;
      t = Math.max(0, Math.min(1, t));
      const li = Math.round(t * 255) * 3;
      row.data[x * 4] = LUT[li];
      row.data[x * 4 + 1] = LUT[li + 1];
      row.data[x * 4 + 2] = LUT[li + 2];
      row.data[x * 4 + 3] = 255;
    }
    ctx.putImageData(row, 0, 0);
  }

  close() {
    this.ws.close();
    window.removeEventListener("mousemove", this._dragMove);
    window.removeEventListener("mouseup", this._dragEnd);
    clear(this.root);
  }
}
