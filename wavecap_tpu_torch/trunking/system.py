"""TrunkingSystem: P25 trunking state machine with voice following.

Behavioral port of reference ``trunking/system.py:850`` redesigned around
the TPU capture: the system owns one capture whose channelizer feeds a
``p25`` control-channel slot plus a pool of ``p25`` voice slots; all demod
runs on-device, and this class consumes symbol streams:

  * control-channel lock/hunt across configured frequencies
    (reference hunt at ``system.py:2382``),
  * IDEN_UP learning -> channel->frequency math (``system.py:2588``),
  * voice grants -> recorder pool assignment and slot retuning
    (``system.py:2024``),
  * call lifecycle with hold timeout and history ring (``system.py:2678``),
  * state persistence: hunt index, locked CC, learned identifiers
    (reference ``~/.wavecapsdr/trunking_state``, ``system.py:81-131``).

The port's copy of ``wavecap_tpu/trunking/system.py``, with the same public names.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from wavecap_tpu_torch.capture import CaptureConfig, CaptureManager, ChannelSpec
from wavecap_tpu_torch.decoders.p25_tsbk import ChannelIdentifier, iden_from_parsed
from .cc_scanner import CCScanner
from .config import HuntMode, TrunkingSystemConfig
from .control import ControlChannelMonitor
from .events import CallSignature, DuplicateDetector
from .recorder import CallInfo, RecorderPool, VoiceRecorder

logger = logging.getLogger(__name__)


@dataclass
class SystemIdentity:
    nac: int | None = None
    system_id: int | None = None
    wacn: int | None = None
    rfss_id: int | None = None
    site_id: int | None = None


class TrunkingSystem:
    CALL_HISTORY = 200

    def __init__(
        self,
        config: TrunkingSystemConfig,
        capture_manager: CaptureManager,
        state_dir: str | Path | None = None,
    ):
        self.config = config
        self.capture_manager = capture_manager
        self.state_dir = Path(state_dir) if state_dir else Path.home() / ".wavecap_tpu" / "trunking_state"
        self.state = "created"  # created|starting|running|stopped|failed
        self.error: str | None = None

        self.identity = SystemIdentity()
        self.identifiers: dict[int, ChannelIdentifier] = {}
        self.cc_index = 0  # index into the current hunt candidate list
        # The frequency the cc channel is actually tuned to.  Hunt candidates
        # include learned adjacent-site CCs beyond config.control_channels, so
        # _on_sync/status must use this rather than re-indexing the config list.
        self._cc_current_freq: float | None = None
        self.cc_locked: float | None = None
        self.cc_lock_time = 0.0
        self.last_tsbk_time = 0.0
        # operator overrides (reference trunking/api.py per-channel
        # enable/lock): disabled CCs are excluded from hunting; a lock
        # override pins hunting to one frequency
        self.disabled_ccs: set[float] = set()
        self.cc_lock_override: float | None = None

        self.capture = None
        self.monitor: ControlChannelMonitor | None = None
        self.pool: RecorderPool | None = None
        self.active_calls: dict[int, CallInfo] = {}  # tgid -> call
        from wavecap_tpu_torch.decoders.lrrp import LocationCache

        self.locations = LocationCache()
        self.adjacent_sites: dict[str, dict] = {}
        self.services: dict | None = None
        self.duplicates = DuplicateDetector(window_s=3.0)
        # sync-verified candidate scoring + roam policy (reference
        # trunking/cc_scanner.py); probes run through an idle voice slot
        self.scanner = CCScanner(
            probe_window_s=config.probe_window_s,
            roam_interval_s=config.roam_interval_s,
            roam_margin_db=config.roam_margin_db,
        )
        self._probe_slot: str | None = None
        self._dedicated_probe: str | None = None  # Phase 2 4800-baud CC probe
        self._cc_power: dict[float, float] = {}  # freq -> last measured dBFS
        self.call_history: deque = deque(maxlen=self.CALL_HISTORY)
        self.events = deque(maxlen=500)  # (time, type, payload) for the API/WS
        self.message_log: deque = deque(maxlen=500)

        self.on_event: Callable[[str, dict], None] | None = None

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.RLock()
        self._load_state()

    # -- persistence -------------------------------------------------------

    def _state_path(self) -> Path:
        return self.state_dir / f"{self.config.id}.json"

    def _load_state(self) -> None:
        try:
            d = json.loads(self._state_path().read_text())
        except (OSError, ValueError):
            return
        self.cc_index = int(d.get("cc_index", 0)) % max(
            len(self.config.control_channels), 1
        )
        self.cc_locked = d.get("cc_locked")
        for k, v in (d.get("identifiers") or {}).items():
            try:
                self.identifiers[int(k)] = ChannelIdentifier(**v)
            except TypeError:
                pass
        ident = d.get("identity") or {}
        for f_ in ("nac", "system_id", "wacn", "rfss_id", "site_id"):
            if ident.get(f_) is not None:
                setattr(self.identity, f_, ident[f_])

    def _save_state(self) -> None:
        try:
            self.state_dir.mkdir(parents=True, exist_ok=True)
            d = {
                "cc_index": self.cc_index,
                "cc_locked": self.cc_locked,
                "identifiers": {k: asdict(v) for k, v in self.identifiers.items()},
                "identity": asdict(self.identity),
            }
            self._state_path().write_text(json.dumps(d, indent=2))
        except OSError:  # pragma: no cover
            logger.warning("could not persist trunking state", exc_info=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self.state == "running":
                return
            self.state = "starting"
            cfg = self.config
            if not cfg.control_channels:
                self.state = "failed"
                self.error = "no control channels configured"
                return
            from .config import TrunkingProtocol


            cap_cfg = CaptureConfig(
                center_hz=cfg.effective_center_hz(),
                sample_rate=cfg.sample_rate,
                # 0.15 s blocks, two per dispatch: remote-TPU per-dispatch
                # overhead is fixed (~100 ms serialized upload+fetch RPCs),
                # so amortizing it over 0.3 s of IQ is what clears 2x
                # real-time; worst-case grant reaction = 0.3 s accumulation
                # + ~0.1 s dispatch/fetch = 0.4 s, inside the reference's
                # ~0.5 s envelope
                block_seconds=0.15,
                blocks_per_dispatch=2,
                narrow_capacity=0,
                wide_capacity=0,
                # Phase 2 systems: the control channel stays a 4800-baud
                # FDMA slot (CQPSK/LSM), while voice channels are 6000-baud
                # H-DQPSK TDMA and live in the dedicated p25p2 bank — the
                # two symbol rates run simultaneously in one capture
                # (reference keeps one 6000-baud decoder per channel and a
                # separate Phase 1 CC; decoders/p25_phase2.py:7)
                # Phase 2 keeps a SECOND 4800-baud slot as a dedicated CC
                # probe: voice slots are 6000-baud and cannot sync-verify a
                # 4800-baud control-channel candidate
                p25_capacity=(
                    2
                    if cfg.protocol == TrunkingProtocol.P25_PHASE2
                    else 1 + cfg.max_voice_channels
                ),
                p25p2_capacity=(
                    cfg.max_voice_channels
                    if cfg.protocol == TrunkingProtocol.P25_PHASE2
                    else 0
                ),
                # Phase 2 FDMA CC is CQPSK (LSM); Phase 1 defaults to C4FM
                # (reference system.py:437 vocoder select)
                p25_equalizer_taps=cfg.effective_equalizer_taps,
                p25_modulation=(
                    cfg.modulation
                    or (
                        "cqpsk"
                        if cfg.protocol == TrunkingProtocol.P25_PHASE2
                        else "c4fm"
                    )
                ),
                # Adaptive-scale int8 IQ transport: digital voice tolerates
                # the 8-bit front-end dynamic-range model (RTL-SDRs are
                # 8-bit), and upload bandwidth is the real-time budget on
                # relay-attached TPUs.  "i4" (config) halves it again.
                transport=cfg.transport,
                # two batches in flight: upload k+1 proceeds while k computes
                # and k-1 fetches.  A real-time-paced SDR keeps the queue at
                # 0-1 in steady state, so grant latency stays ~one block.
                pipeline_depth=2,
                # multi-chip: run the whole trunking program (CC + voice
                # slots as channelizer bins, p25 soft symbols out) on the
                # sharded grid — BASELINE config #5 at pod scale
                mesh=cfg.mesh,
            )
            self.capture = self.capture_manager.create_capture(
                device_id=cfg.device_id, config=cap_cfg
            )
            # Probe settle must cover every block that can still be in
            # flight with the PRE-retune tuning: voice slots are parked on
            # the CC frequency, so a stale batch carries real CC sync and
            # would falsely verify whatever candidate is being probed.
            self.scanner.settle_batches = max(
                1, cap_cfg.pipeline_depth * cap_cfg.blocks_per_dispatch
            )
            cc_freq = self.cc_locked or cfg.control_channels[
                self.cc_index % len(cfg.control_channels)
            ]
            self._cc_current_freq = cc_freq
            self._cc_channel = self.capture.create_channel(
                ChannelSpec(id="cc", mode="p25", frequency_hz=cc_freq, name="control")
            )
            voice_mode = (
                "p25p2"
                if cfg.protocol == TrunkingProtocol.P25_PHASE2
                else "p25"
            )
            self._dedicated_probe = None
            if cfg.protocol == TrunkingProtocol.P25_PHASE2:
                self.capture.create_channel(
                    ChannelSpec(
                        id="probe", mode="p25", frequency_hz=cc_freq,
                        name="cc probe",
                    )
                )
                self._dedicated_probe = "probe"
            voice_ids = []
            for i in range(cfg.max_voice_channels):
                vid = f"voice{i}"
                self.capture.create_channel(
                    ChannelSpec(
                        id=vid, mode=voice_mode, frequency_hz=cc_freq,
                        name=f"voice {i}",
                    )
                )
                voice_ids.append(vid)
            self.pool = RecorderPool(
                voice_ids,
                protocol=cfg.protocol.value,
                dmr_stride=cfg.dmr_slots_per_carrier,
            )
            for rec in self.pool.recorders:
                rec.on_location = self.update_radio_location
            if cfg.protocol == TrunkingProtocol.DMR_TIER3:
                from .control import DmrControlMonitor

                self.monitor = DmrControlMonitor(
                    on_tsbk=self._handle_dmr_csbk,
                    on_sync_acquired=self._on_sync,
                    on_sync_lost=self._on_sync_lost,
                )
            else:
                self.monitor = ControlChannelMonitor(
                    on_tsbk=self._handle_tsbk,
                    on_sync_acquired=self._on_sync,
                    on_sync_lost=self._on_sync_lost,
                )
            self._cc_sub = self._cc_channel.symbols.subscribe()
            self._spectrum_sub = self.capture.spectrum_subs.subscribe(maxsize=2)
            self._cc_power = {}
            self._voice_subs = {
                vid: self.capture.channels[vid].symbols.subscribe()
                for vid in voice_ids
            }
            if self._dedicated_probe:
                # rides the voice-sub pump; pool.by_channel("probe") is
                # None so non-probe batches from it are discarded
                self._voice_subs[self._dedicated_probe] = self.capture.channels[
                    self._dedicated_probe
                ].symbols.subscribe()
            self.capture.start()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"Trunking-{self.config.id}", daemon=True
            )
            self._thread.start()
            self.state = "running"

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        if self.capture:
            self.capture.stop()
            self.capture_manager.remove_capture(self.capture.id)
            self.capture = None
        self._save_state()
        self.state = "stopped"

    # -- worker loop -------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                moved = False
                batch = self._cc_sub.get_nowait()
                if batch is not None:
                    moved = True
                    assert self.monitor is not None
                    self.monitor.process_symbols(batch["soft"])
                for vid, sub in self._voice_subs.items():
                    vb = sub.get_nowait()
                    if vb is not None:
                        moved = True
                        if (
                            self.scanner.probe is not None
                            and self.scanner.probe.channel_id == vid
                        ):
                            self.scanner.feed(vid, vb["soft"], time.time())
                            continue
                        rec = self.pool.by_channel(vid) if self.pool else None
                        if rec is not None:
                            rec.process_symbols(vb["soft"])
                self._check_call_timeouts()
                self._check_hunt()
                if not moved:
                    time.sleep(0.01)
        except Exception as e:  # pragma: no cover
            self.state = "failed"
            self.error = str(e)
            logger.exception("trunking system %s crashed", self.config.id)

    # -- control-channel handling -----------------------------------------

    def _on_sync(self) -> None:
        freq = self._cc_current_freq
        if freq is None:
            freq = self.config.control_channels[
                self.cc_index % len(self.config.control_channels)
            ]
        self.cc_locked = freq
        self.cc_lock_time = time.time()
        self._emit("control_locked", {"frequencyHz": freq})
        self._save_state()

    def _on_sync_lost(self) -> None:
        self._emit("control_lost", {})

    def _candidates(self) -> list[float]:
        """Configured CCs + learned in-band adjacent-site CCs (reference
        roams via network_config adjacent sites)."""
        if self.cc_lock_override is not None:
            return [self.cc_lock_override]
        candidates = list(self.config.control_channels)
        if self.capture:
            half_bw = self.capture.config.sample_rate / 2
            center = self.capture.config.center_hz
            for site in self.adjacent_sites.values():
                f = site.get("frequencyHz")
                if f and f not in candidates and abs(f - center) < half_bw:
                    candidates.append(f)
        enabled = [f for f in candidates if f not in self.disabled_ccs]
        return enabled or candidates  # never hunt an empty list

    def _measure_control_channels(self) -> None:
        """Per-CC power/SNR from the capture spectrum (reference cc_scanner.py)."""
        if self.capture is None:
            return
        spec = self._spectrum_sub.get_nowait()
        if spec is None:
            return
        cands = self._candidates()
        self.scanner.update_spectrum(
            spec,
            self.capture.config.sample_rate,
            self.capture.config.center_hz,
            cands,
            time.time(),
        )
        for f in cands:
            m = self.scanner.measurements.get(f)
            if m is not None:
                self._cc_power[f] = m.power_db

    def _can_probe(self) -> bool:
        """A slot that can sync-verify a 4800-baud CC candidate is free:
        the dedicated probe slot (Phase 2 — its voice slots are 6000-baud
        H-DQPSK and cannot see Phase 1 CC sync) or an idle voice slot."""
        if getattr(self, "_dedicated_probe", None):
            return bool(getattr(self, "_voice_subs", None))
        return bool(
            self.pool is not None
            and getattr(self, "_voice_subs", None)
            and self.pool.available() is not None
        )

    def _start_probe(self, freq: float, now: float) -> None:
        if self.capture is None:
            return
        if getattr(self, "_dedicated_probe", None):
            slot = self._dedicated_probe
        else:
            rec = self.pool.available() if self.pool else None
            if rec is None:
                return
            slot = rec.channel_id
        self._probe_slot = slot
        try:
            self.capture.update_channel(slot, frequency_hz=freq)
        except ValueError:
            # mesh bin collision (see _handle_voice_grant): skip this probe
            self._probe_slot = None
            return
        self.scanner.start_probe(freq, slot, now)

    def _retune_cc(self, freq: float, candidates: list[float], now: float, reason: str) -> None:
        self.cc_index = candidates.index(freq) if freq in candidates else 0
        self._cc_current_freq = freq
        if self.capture:
            self.capture.update_channel("cc", frequency_hz=freq)
        if self.monitor:
            self.monitor.reset()
        self.cc_lock_time = now
        self.cc_locked = None
        self._emit("control_roam" if reason == "roam" else "control_hunt", {"frequencyHz": freq})
        self._save_state()

    # -- operator controls (reference trunking/api.py) ----------------------

    def set_hunt_mode(self, mode: str) -> None:
        self.config.hunt_mode = HuntMode(mode)

    def set_cc_enabled(self, freq: float, enabled: bool) -> None:
        """Exclude/include one control-channel candidate from hunting."""
        if enabled:
            self.disabled_ccs.discard(freq)
        else:
            self.disabled_ccs.add(freq)

    def set_cc_lock(self, freq: float | None) -> None:
        """Pin hunting to one frequency (None clears); retunes immediately
        when running on a different CC."""
        with self._lock:
            self.cc_lock_override = freq
            if (
                freq is not None
                and self.state == "running"
                and self._cc_current_freq != freq
            ):
                self._retune_cc(freq, [freq], time.time(), reason="manual-lock")

    def trigger_scan(self) -> None:
        """Force re-verification of every candidate: drop cached
        measurements so the hunt loop re-probes them all.  REBIND rather
        than mutate: the worker thread iterates this dict without a lock,
        and in-place clear() would raise mid-iteration and fail the
        system."""
        self.scanner.measurements = {}
        self.scanner.last_roam_check = 0.0

    def voice_streams(self) -> list[dict]:
        """Per-recorder status (reference GET .../voice-streams)."""
        if self.pool is None:
            return []
        return [
            {
                "recorderId": r.id,
                "channelId": r.channel_id,
                "state": r.state,
                "tgid": r.call.tgid if r.call else None,
                "talkgroup": r.call.talkgroup_name if r.call else None,
                "frequencyHz": r.call.frequency_hz if r.call else None,
                "startTime": r.call.start_time if r.call else None,
            }
            for r in self.pool.recorders
        ]

    def _check_hunt(self) -> None:
        if self.config.hunt_mode == HuntMode.FIXED:
            return
        self._measure_control_channels()
        now = time.time()
        if self.scanner.poll(now) is not None:
            self._probe_slot = None
        candidates = self._candidates()
        if self.monitor and self.monitor.synced:
            # Roam while locked: periodically sync-verify one other candidate
            # through an idle slot; move when one is roam_margin_db stronger
            # (reference system.py:1670-1733, re-checked every 30 s).
            if len(candidates) <= 1:
                return
            if (
                now - self.scanner.last_roam_check >= self.config.roam_interval_s
                and self.scanner.probe is None
                and self._can_probe()
            ):
                self.scanner.last_roam_check = now
                tgt = self.scanner.next_roam_candidate(candidates, self._cc_current_freq)
                if tgt is not None:
                    self._start_probe(tgt, now)
            better = self.scanner.should_roam(self._cc_current_freq, now)
            if better is not None:
                self._retune_cc(better, candidates, now, reason="roam")
            return
        last = max(self.last_tsbk_time, self.cc_lock_time)
        if now - last < self.config.hunt_timeout_s or not self.capture:
            return
        n = len(candidates)
        if n <= 1:
            self.cc_lock_time = now
            return
        self.cc_index %= n
        if self._can_probe():
            # Sync-verified scan-all (reference cc_scanner initial scan):
            # probe every unverified candidate through an idle voice slot,
            # then retune the CC to the best-ranked one — a verified P25
            # sync always beats a louder sync-less carrier.
            if self.scanner.probe is not None:
                return  # probe window in flight
            todo = self.scanner.unverified(candidates, max_age_s=60.0, now=now)
            if todo:
                self._start_probe(todo[0], now)
                return
            best = self.scanner.best(candidates)
            if best is not None and best != self._cc_current_freq:
                self._retune_cc(best, candidates, now, reason="hunt")
                return
            # Already on the best-ranked candidate but still unlocked:
            # invalidate probe results and fall through to rotation so we
            # neither deadlock nor trust stale verifications.
            for m in self.scanner.measurements.values():
                m.time = 0.0
                m.sync_detected = False
        if self.config.hunt_mode == HuntMode.SCAN and self._cc_power:
            current = candidates[self.cc_index]
            ranked = sorted(
                candidates, key=lambda f: -self._cc_power.get(f, -999.0)
            )
            nxt = next((f for f in ranked if f != current), ranked[0])
            freq = nxt
        else:
            freq = candidates[(self.cc_index + 1) % n]
        self._retune_cc(freq, candidates, now, reason="hunt")

    def _handle_tsbk(self, parsed: dict, block) -> None:
        self.last_tsbk_time = time.time()
        t = parsed.get("type")
        self.message_log.append({"time": self.last_tsbk_time, **parsed})
        if parsed.get("nac") is not None:
            self.identity.nac = parsed["nac"]
        if t in ("IDENTIFIER_UPDATE", "IDENTIFIER_UPDATE_VU", "IDENTIFIER_UPDATE_TDMA"):
            ident = iden_from_parsed(parsed)
            # air-interface data is untrusted: a corrupt-but-CRC-lucky IDEN
            # must not poison the channel->frequency map (reference range-
            # checks derived frequencies; validation.py)
            from wavecap_tpu_torch.utils.validation import plausible_iden

            if plausible_iden(
                ident.base_freq_mhz, ident.channel_spacing_khz, ident.bandwidth_khz
            ):
                self.identifiers[ident.identifier] = ident
                self._save_state()
            else:
                self._emit(
                    "iden_rejected",
                    {"identifier": ident.identifier, "baseMHz": ident.base_freq_mhz},
                )
        elif t == "RFSS_STATUS":
            self.identity.system_id = parsed.get("system_id")
            self.identity.rfss_id = parsed.get("rfss_id")
            self.identity.site_id = parsed.get("site_id")
        elif t == "NETWORK_STATUS":
            self.identity.wacn = parsed.get("wacn")
            self.identity.system_id = parsed.get("system_id")
        elif t == "ADJACENT_STATUS":
            # neighbor-site table (reference trunking/network_config.py
            # AdjacentSite tracking): keyed by (rfss, site)
            key = f"{parsed.get('rfss_id')}-{parsed.get('site_id')}"
            self.adjacent_sites[key] = {
                "systemId": parsed.get("system_id"),
                "rfssId": parsed.get("rfss_id"),
                "siteId": parsed.get("site_id"),
                "frequencyHz": self.calculate_frequency(
                    parsed.get("frequency_band", 0),
                    parsed.get("channel_number", 0),
                ),
                "serviceClass": parsed.get("service_class"),
                "lastSeen": self.last_tsbk_time,
            }
        elif t == "SYSTEM_SERVICE":
            self.services = parsed
        elif t in ("GROUP_VOICE_GRANT", "GROUP_VOICE_GRANT_UPDATE"):
            self._handle_voice_grant(parsed)

    # -- voice -------------------------------------------------------------

    def calculate_frequency(self, band: int, channel_number: int) -> float | None:
        ident = self.identifiers.get(band)
        if ident is None:
            return None
        return ident.frequency_hz(channel_number)

    def _handle_voice_grant(self, parsed: dict) -> None:
        tgid = parsed.get("tgid")
        if tgid is None or self.pool is None or self.capture is None:
            return
        band = parsed.get("frequency_band", 0)
        chan = parsed.get("channel_number", 0)
        freq = self.calculate_frequency(band, chan)
        if freq is None:
            return
        ident = self.identifiers.get(band)
        tdma_slot = ident.slot(chan) if ident is not None else 0
        self._grant_call(tgid, parsed, freq, tdma_slot)

    def _handle_dmr_csbk(self, parsed: dict, block=None) -> None:
        """DMR Tier III CSBK -> call bookkeeping.  Voice grants map the
        logical channel through the configured channel plan (base +
        carrier*spacing, timeslot = LCN parity)."""
        self.message_log.append({"time": time.time(), **{
            k: v for k, v in parsed.items() if k != "data"
        }})
        if parsed.get("type") not in ("PV_GRANT", "TV_GRANT", "BTV_GRANT"):
            return
        tgid = parsed.get("dst_id")
        if tgid is None or self.pool is None or self.capture is None:
            return
        cfg = self.config
        base = cfg.dmr_base_hz or (
            cfg.control_channels[0] if cfg.control_channels else None
        )
        if base is None:
            return
        lcn = int(parsed.get("channel", 0))
        slots = max(1, cfg.dmr_slots_per_carrier)
        carrier = max(0, lcn - 1) // slots
        # Tier III networks address the timeslot either by LCN parity or by
        # the grant's explicit slot bit; trust the bit when it is set,
        # otherwise fall back to parity.
        tdma_slot = int(parsed.get("slot") or 0) or max(0, lcn - 1) % slots
        freq = float(base) + carrier * cfg.dmr_spacing_hz
        # Round 5: the voice trackers route bursts by the CACH TC bit, so
        # two concurrent calls CAN share one carrier — one per timeslot
        # (decoders/dmr.py burst_tdma_slot).  Only a same-slot collision
        # (different talkgroup granted on a slot we're already recording)
        # still has to be skipped.
        for c in self.active_calls.values():
            if abs(c.frequency_hz - freq) < 1.0 and c.tgid != tgid:
                if slots >= 2 and c.tdma_slot != tdma_slot:
                    continue  # other timeslot: independent call
                self._emit(
                    "grant_same_carrier_busy",
                    {"tgid": tgid, "frequencyHz": freq, "activeTgid": c.tgid},
                )
                return
        grant = {
            "tgid": tgid,
            "source_id": parsed.get("src_id", 0),
            "emergency": parsed.get("emergency", False),
        }
        self._grant_call(tgid, grant, freq, tdma_slot)

    def _grant_call(
        self, tgid: int, parsed: dict, freq: float, tdma_slot: int
    ) -> None:
        """Shared grant -> recorder assignment (P25 TSBK and DMR CSBK)."""
        tg = self.config.talkgroup(tgid)
        if not tg.monitor:
            return
        from wavecap_tpu_torch.utils.validation import plausible_rf_hz

        if not plausible_rf_hz(freq):
            self._emit("grant_bad_frequency", {"tgid": tgid, "frequencyHz": freq})
            return
        now = time.time()
        existing = self.pool.for_tgid(tgid)
        if existing is not None:
            existing.last_activity = now  # grant update extends the call
            return
        if self.duplicates.is_duplicate(
            CallSignature(tgid=tgid, frequency_hz=freq), now
        ):
            return
        half = self.config.sample_rate / 2
        off = freq - self.capture.config.center_hz
        if not (-half < off < half):
            self._emit("grant_out_of_band", {"tgid": tgid, "frequencyHz": freq})
            return
        rec = self.pool.available()
        if rec is None:
            self._emit("grant_no_recorder", {"tgid": tgid})
            return
        if rec.channel_id == self._probe_slot:
            # voice wins over a CC probe using the same idle slot
            self.scanner.abort_probe()
            self._probe_slot = None
        call = CallInfo(
            tgid=tgid,
            source_id=parsed.get("source_id", 0),
            frequency_hz=freq,
            start_time=now,
            system_id=self.config.id,
            talkgroup_name=tg.name,
            emergency=bool(parsed.get("emergency")),
            encrypted=bool(parsed.get("encrypted")),
            tdma_slot=tdma_slot,
        )
        try:
            self.capture.update_channel(rec.channel_id, frequency_hz=freq)
        except ValueError as e:
            # mesh backend: the granted frequency's channelizer bin can be
            # held by a different-frequency channel (adjacent 12.5 kHz
            # assignments sharing one 25 kHz bin) — skip the grant rather
            # than corrupt another channel's tuning
            self._emit(
                "grant_skipped",
                {"tgid": tgid, "frequencyHz": freq, "reason": str(e)},
            )
            return
        rec.assign(call)
        self.active_calls[tgid] = call
        self._emit(
            "call_start",
            {
                "tgid": tgid,
                "talkgroup": tg.name,
                "sourceId": call.source_id,
                "frequencyHz": freq,
                "recorder": rec.id,
            },
        )

    def _check_call_timeouts(self) -> None:
        if self.pool is None:
            return
        now = time.time()
        for rec in self.pool.recording():
            if rec.call is None:
                continue
            if now - rec.last_activity > self.config.call_hold_s:
                self._end_call(rec, now)

    def _end_call(self, rec: VoiceRecorder, now: float) -> None:
        rec_dir = (
            Path(self.config.recording_dir) / self.config.id
            if self.config.record_audio
            else None
        )
        tg = self.config.talkgroup(rec.call.tgid) if rec.call else None
        if tg is not None and not tg.record:
            rec_dir = None
        call = rec.finalize(rec_dir, self.config.min_call_duration_s, now)
        if call is not None:
            self.active_calls.pop(call.tgid, None)
            self.call_history.appendleft(call)
            self._emit(
                "call_end",
                {
                    "tgid": call.tgid,
                    "durationS": round((call.end_time or now) - call.start_time, 2),
                    "imbeFrames": call.imbe_frames,
                },
            )

    # -- misc --------------------------------------------------------------

    def _emit(self, event_type: str, payload: dict) -> None:
        evt = {"time": time.time(), "type": event_type, "systemId": self.config.id, **payload}
        self.events.append(evt)
        if self.on_event:
            try:
                self.on_event(event_type, evt)
            except Exception:  # pragma: no cover
                logger.exception("event callback failed")

    def update_radio_location(self, location) -> None:
        """Cache an LRRP GPS report and attach it to the unit's active call
        (reference ``trunking/system.py:3112-3146``)."""
        from dataclasses import asdict

        self.locations.update(location)
        for call in self.active_calls.values():
            if call.source_id == location.radio_id:
                call.source_location = asdict(location)
        self._emit(
            "radio_location",
            {"unitId": location.radio_id, "latitude": location.latitude,
             "longitude": location.longitude},
        )

    def status(self) -> dict:
        mon = self.monitor.stats if self.monitor else None
        return {
            "id": self.config.id,
            "name": self.config.name,
            "state": self.state,
            "error": self.error,
            "protocol": self.config.protocol.value,
            "modulation": self.config.modulation,
            "equalizerTaps": self.config.effective_equalizer_taps,
            "mesh": self.config.mesh,
            "controlChannelHz": self.cc_locked
            or self._cc_current_freq
            or (
                self.config.control_channels[
                    self.cc_index % len(self.config.control_channels)
                ]
                if self.config.control_channels
                else None
            ),
            "synced": bool(self.monitor and self.monitor.synced),
            "nac": self.identity.nac,
            "systemId": self.identity.system_id,
            "rfssId": self.identity.rfss_id,
            "siteId": self.identity.site_id,
            "wacn": self.identity.wacn,
            "tsbkCount": mon.tsbk_total if mon else 0,
            "tsbkCrcRate": round(mon.crc_rate, 3) if mon else 0.0,
            "tsbkCountSteady": mon.tsbk_total_steady if mon else 0,
            "tsbkCrcRateSteady": round(mon.crc_rate_steady, 3) if mon else 0.0,
            "identifiers": {
                k: asdict(v) for k, v in self.identifiers.items()
            },
            "adjacentSites": list(self.adjacent_sites.values()),
            "ccMeasurements": self.scanner.status(),
            "services": self.services,
            "activeCalls": [
                {
                    "tgid": c.tgid,
                    "talkgroup": c.talkgroup_name,
                    "sourceId": c.source_id,
                    "frequencyHz": c.frequency_hz,
                    "startTime": c.start_time,
                    "sourceLocation": c.source_location,
                    "tdmaSlot": c.tdma_slot,
                }
                for c in self.active_calls.values()
            ],
        }
