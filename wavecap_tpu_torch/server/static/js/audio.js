// WebAudio PCM player: schedules int16 mono chunks from a WS on a shared
// AudioContext clock (same role as the reference frontend's AudioService).

import { openWs } from "./api.js";

let ctx = null;

function audioCtx() {
  if (!ctx) ctx = new (window.AudioContext || window.webkitAudioContext)();
  if (ctx.state === "suspended") ctx.resume();
  return ctx;
}

const LEAD = 0.08;     // scheduling headroom (s)
const MAX_AHEAD = 1.0; // drop if we fall this far behind real time

export class ChannelPlayer {
  constructor(wsPath, { rate = 48000 } = {}) {
    this.rate = rate;
    this.gainNode = audioCtx().createGain();
    this.gainNode.connect(audioCtx().destination);
    this.nextTime = 0;
    this.level = 0;   // last chunk RMS 0..1 for VU display
    this.levels = []; // rolling RMS ring for the waveform canvas
    this.ws = openWs(wsPath, {
      binary: (buf) => this._chunk(buf),
    });
  }

  _chunk(buf) {
    const c = audioCtx();
    const i16 = new Int16Array(buf);
    if (!i16.length) return;
    const f32 = new Float32Array(i16.length);
    let sum = 0;
    for (let i = 0; i < i16.length; i++) {
      const v = i16[i] / 32768;
      f32[i] = v;
      sum += v * v;
    }
    this.level = Math.sqrt(sum / i16.length);
    this.levels.push(this.level);
    if (this.levels.length > 60) this.levels.shift();
    const ab = c.createBuffer(1, f32.length, this.rate);
    ab.getChannelData(0).set(f32);
    const src = c.createBufferSource();
    src.buffer = ab;
    src.connect(this.gainNode);
    const now = c.currentTime;
    if (this.nextTime < now + LEAD) this.nextTime = now + LEAD;
    if (this.nextTime > now + MAX_AHEAD) {
      // queue ran away (tab was hidden): restart the clock
      this.nextTime = now + LEAD;
    }
    src.start(this.nextTime);
    this.nextTime += ab.duration;
  }

  set volume(v) { this.gainNode.gain.value = v; }
  get volume() { return this.gainNode.gain.value; }

  close() {
    this.ws.close();
    this.gainNode.disconnect();
  }
}
