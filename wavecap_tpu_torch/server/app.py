"""Application wiring: state, REST routes, WebSocket streams, bootstrap.

Behavioral port of the reference's service layer (reference ``app.py:179``
``create_app``, ``state.py:71`` ``AppState.from_config``, ``api.py`` REST
surface, ``trunking/api.py``): same ``/api/v1`` paths and camelCase JSON
shapes so reference clients work against this server.

In the port ``AppState`` / ``AppServer`` take ``device``: the torch device
of every capture and of the trunking workers (the CUDA card unless
``"cpu"`` is asked for).

The port's copy of ``wavecap_tpu/server/app.py``, with the same public names.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from wavecap_tpu_torch.capture import Capture, CaptureConfig, CaptureManager, ChannelSpec
from wavecap_tpu_torch.devices import FakeDriver, FileReplayDriver
from wavecap_tpu_torch.trunking import (
    TalkgroupConfig,
    TrunkingManager,
    TrunkingSystemConfig,
)
from wavecap_tpu_torch.utils import config as config_mod
from wavecap_tpu_torch.utils.observability import (
    ERROR_TRACKER,
    LOG_RING,
    STATE_BROADCASTER,
    system_metrics,
)
from wavecap_tpu_torch.utils.wavio import pack_iq16, pack_pcm16, pack_f32
from .httpd import HttpError, HttpServer, Request, Response, Router, WebSocket

logger = logging.getLogger(__name__)


def create_device_driver(cfg: config_mod.AppConfig):
    """Driver selection (reference state.py:29-54):
    fake | file | rtl | soapy | native | auto (composite)."""
    d = cfg.device
    if d.driver in ("auto", "composite"):
        from wavecap_tpu_torch.devices.composite import CompositeDriver

        return CompositeDriver(show_fake_device=d.show_fake_device)
    if d.driver == "file" and d.file_path:
        return FileReplayDriver(d.file_path)
    if d.driver == "native":
        from wavecap_tpu_torch.devices.native import NativeDriver, native_available

        if native_available():
            return NativeDriver()
        logger.warning("native ingest unavailable; falling back to fake")
    if d.driver == "soapy":  # pragma: no cover - hardware
        try:
            from wavecap_tpu_torch.devices.soapy import SoapyDriver

            return SoapyDriver(d.device_args)
        except Exception as e:
            logger.warning("SoapySDR unavailable (%s); falling back to fake", e)
    if d.driver == "rtl":  # pragma: no cover - hardware
        from wavecap_tpu_torch.devices.rtl import RtlDriver, rtl_available

        if rtl_available():
            return RtlDriver()
        logger.warning("librtlsdr unavailable; falling back to fake")
    return FakeDriver()


class WorkerStreamHub:
    """Server-side fan-outs for streams forwarded from trunking worker
    processes over the event pipe (reference process_manager.py:262+).

    Worker messages arrive on the manager's event-pump thread; FanOut is
    thread-safe, so WS/HTTP pumps subscribe exactly like they do against
    in-process recorders/captures."""

    def __init__(self):
        from wavecap_tpu_torch.utils.broadcast import FanOut

        self._FanOut = FanOut
        self._lock = threading.Lock()
        self.spectrum: dict[str, Any] = {}  # system id -> FanOut
        self.voice_all: dict[str, Any] = {}  # system id -> FanOut (any rec)
        self.voice_one: dict[tuple, Any] = {}  # (sid, rid) -> FanOut
        self.latest_spectrum: dict[str, dict] = {}
        self.known_recorders: dict[str, set] = {}

    def _get(self, table: dict, key) -> Any:
        with self._lock:
            fo = table.get(key)
            if fo is None:
                fo = table[key] = self._FanOut(maxsize=16)
            return fo

    def publish_spectrum(self, sid: str, msg: dict) -> None:
        self.latest_spectrum[sid] = msg
        self._get(self.spectrum, sid).publish(msg)

    def publish_voice(self, sid: str, rid: int, pcm: bytes) -> None:
        self.known_recorders.setdefault(sid, set()).add(rid)
        self._get(self.voice_all, sid).publish(pcm)
        self._get(self.voice_one, (sid, rid)).publish(pcm)


class AppState:
    def __init__(self, cfg: config_mod.AppConfig, device=None):
        self.config = cfg
        self.driver = create_device_driver(cfg)
        from wavecap_tpu_torch.devices.recovery import ServiceRecovery, UsbPowerCycler

        # driver-service recovery + USB power cycling (reference
        # sdrplay_recovery.py / uhubctl.py, served at api.py:1098-1191)
        self.recovery = ServiceRecovery()
        self.usb = UsbPowerCycler()
        self.captures = CaptureManager(
            self.driver,
            max_captures=cfg.limits.max_captures,
            recovery=self.recovery,
            device=device,
        )
        self.trunking = TrunkingManager(self.captures)
        # process-per-device mode (reference trunking_workers config,
        # state.py:78-86): systems run in worker processes; the in-process
        # manager still serves ad-hoc REST-created systems.
        self.trunking_workers = None
        # fan-outs for worker-forwarded streams (spectrum frames + voice
        # PCM), so WS/HTTP clients can stream from process-isolated
        # systems exactly like in-process ones (round-2 gap: per-device
        # mode went dark for clients)
        self.worker_streams = WorkerStreamHub()
        if cfg.trunking_workers.mode == "per_device":
            from wavecap_tpu_torch.trunking.process_manager import TrunkingProcessManager

            self.trunking_workers = TrunkingProcessManager(
                driver=cfg.device.driver, device=device
            )
            self.attach_worker_streams(self.trunking_workers)
        self.started_at = time.time()
        self._chan_ids = itertools.count(1)
        self.trunking.on_event = self._trunking_event
        self._trunking_event_subs: set = set()
        self.scanners: dict = {}
        self.attachments: dict = {}  # (channel_id, kind) -> attachment
        self.nicknames = self._load_nicknames()
        from collections import deque

        self.frontend_logs: deque = deque(maxlen=1000)
        self.shutdown_requested = False
        self.on_shutdown_request = None  # set by the server runner

    # -- device nicknames (persisted next to trunking state) --------------

    def _nickname_path(self):
        from pathlib import Path

        return Path.home() / ".wavecap_tpu" / "device_nicknames.json"

    def _load_nicknames(self) -> dict:
        import json

        try:
            return json.loads(self._nickname_path().read_text())
        except (OSError, ValueError):
            return {}

    def set_nickname(self, device_id: str, nickname) -> None:
        import json

        if nickname:
            self.nicknames[device_id] = str(nickname)
        else:
            self.nicknames.pop(device_id, None)
        try:
            p = self._nickname_path()
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(self.nicknames, indent=2))
        except OSError:  # pragma: no cover
            logger.warning("could not persist device nicknames")

    # -- id helpers --------------------------------------------------------

    def new_channel_id(self) -> str:
        return f"ch{next(self._chan_ids)}"

    def find_channel(self, channel_id: str):
        for cap in self.captures.captures.values():
            ch = cap.channels.get(channel_id)
            if ch is not None:
                return cap, ch
        raise HttpError(404, f"channel {channel_id} not found")

    def get_capture(self, capture_id: str) -> Capture:
        cap = self.captures.captures.get(capture_id)
        if cap is None:
            raise HttpError(404, f"capture {capture_id} not found")
        return cap

    def _trunking_event(self, event_type: str, evt: dict) -> None:
        for cb in list(self._trunking_event_subs):
            try:
                cb(evt)
            except Exception:
                pass

    def attach_worker_streams(self, workers) -> None:
        """Route a process manager's forwarded events/spectrum/voice into
        the server's event subscribers and stream hub."""
        workers.on_event = self._trunking_event
        workers.on_spectrum = self.worker_streams.publish_spectrum
        workers.on_voice = self.worker_streams.publish_voice

    # -- bootstrap ---------------------------------------------------------

    def apply_config(self) -> None:
        """Create configured captures/channels/trunking (lifespan autostart)."""
        for spec in self.config.captures:
            cap = self.captures.create_capture(
                capture_id=spec.id,
                device_id=spec.device_id,
                config=CaptureConfig(
                    center_hz=spec.center_hz,
                    sample_rate=spec.sample_rate,
                    gain_db=spec.gain_db,
                    mesh=spec.mesh or self.config.stream.mesh,
                    transport=self.config.stream.transport,
                    adaptive_transport=self.config.stream.adaptive_transport,
                    narrow_capacity=self.config.limits.max_channels_per_capture,
                    wide_capacity=self.config.limits.max_wide_channels,
                    p25_capacity=self.config.limits.max_p25_channels,
                    p25p2_capacity=self.config.limits.max_p25p2_channels,
                    audio_rate=self.config.stream.audio_rate,
                    audio_fetch_slots=self.config.stream.audio_fetch_slots,
                    fft_size=self.config.stream.fft_size,
                ),
            )
            for ch in spec.channels:
                cap.create_channel(
                    ChannelSpec(
                        id=ch.id,
                        mode=ch.mode,
                        frequency_hz=ch.frequency_hz,
                        squelch_db=ch.squelch_db,
                        name=ch.name,
                        dsp=dict(ch.dsp),
                    )
                )
            if spec.auto_start:
                cap.start()
            else:
                # boot-time warmup: build the kernels and the capture's
                # program for configured-but-idle captures so a later
                # start reaches first audio without the build stall
                # (round 4; reference restarts captures from YAML
                # instantly, reference app.py:188-351)
                cap.warmup()
        for tdict in self.config.trunking_systems:
            if self.trunking_workers is not None:
                self.trunking_workers.add_system(tdict)
            else:
                cfg = TrunkingSystemConfig.from_dict(tdict)
                self.trunking.create_system(cfg)
                if tdict.get("auto_start", True):
                    self.trunking.get(cfg.id).start()
        if self.trunking_workers is not None and self.config.trunking_systems:
            self.trunking_workers.start()

    def shutdown(self) -> None:
        if self.trunking_workers is not None:
            self.trunking_workers.stop_all()
        self.trunking.stop_all()
        self.captures.stop_all()


# ---------------------------------------------------------------------------
# JSON shapes (camelCase, reference models.py)
# ---------------------------------------------------------------------------


def capture_json(cap: Capture) -> dict:
    return cap.status()


def channel_json(cap: Capture, ch) -> dict:
    return {
        "id": ch.id,
        "captureId": cap.id,
        "mode": ch.spec.mode,
        "frequencyHz": ch.spec.frequency_hz,
        "name": ch.spec.name,
        "squelchDb": ch.spec.squelch_db,
        "rssiDb": round(ch.rssi_db, 1),
        "state": ch.state,
        "audioSubscribers": ch.audio.count,
        "dsp": {k: list(v) if isinstance(v, tuple) else v
                for k, v in ch.spec.dsp.items()},
    }


# Reference ChannelSettings field names (api.py channel update) -> demod
# config fields.  Values pass through except where a converter is given.
DSP_FIELDS: dict[str, tuple[str, Any]] = {
    "enableDeemphasis": ("enable_deemphasis", None),
    "deemphasisTauUs": ("deemphasis_tau", lambda v: float(v) * 1e-6),
    "enableMpxFilter": ("enable_mpx_filter", None),
    "mpxCutoffHz": ("mpx_cutoff_hz", float),
    "enableFmHighpass": ("enable_highpass", None),
    "fmHighpassHz": ("highpass_hz", float),
    "enableFmLowpass": ("enable_lowpass", None),
    "fmLowpassHz": ("lowpass_hz", float),
    "enableAmHighpass": ("enable_highpass", None),
    "amHighpassHz": ("highpass_hz", float),
    "enableAmLowpass": ("enable_lowpass", None),
    "amLowpassHz": ("lowpass_hz", float),
    "enableSsbBandpass": ("enable_bandpass", None),
    "ssbBandpassLowHz": ("bandpass_low", float),
    "ssbBandpassHighHz": ("bandpass_high", float),
    "ssbBfoOffsetHz": ("bfo_offset_hz", float),
    "enableAgc": ("enable_agc", None),
    "agcTargetDb": ("agc_target_db", float),
    "enableNoiseBlanker": ("enable_noise_blanker", None),
    "noiseBlankerThresholdDb": ("noise_blanker_threshold_db", float),
    "enableNoiseReduction": ("enable_noise_reduction", None),
    "noiseReductionDb": ("noise_reduction_db", float),
    "notchFrequencies": (
        "notch_frequencies",
        lambda v: tuple(float(x) for x in v),
    ),
    "maxDeviationHz": ("max_deviation_hz", float),
    "targetRms": ("target_rms", float),
    "fastDiscriminator": ("fast_discriminator", None),
    "pllBandwidthHz": ("pll_bandwidth_hz", float),
}


def dsp_from_body(body: dict) -> dict | None:
    """Collect DSP overrides from a channel create/update body.

    Accepts both the reference's camelCase names (DSP_FIELDS) and raw
    snake_case config fields under ``dsp``; null values remove an
    override.  Returns None when the body carries no DSP keys."""
    out: dict = {}
    for camel, (snake, conv) in DSP_FIELDS.items():
        if camel in body:
            v = body[camel]
            out[snake] = None if v is None else (conv(v) if conv else v)
    raw = body.get("dsp")
    if isinstance(raw, dict):
        for k, v in raw.items():
            out[k] = tuple(v) if isinstance(v, list) else v
    return out or None


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def _recipe_dirs():
    roots = [Path("config"), Path(__file__).resolve().parents[2] / "config"]
    seen, dirs = set(), []
    for root in roots:
        for d in (root / "recipes", root / "presets"):
            rd = d.resolve()
            if d.is_dir() and rd not in seen:
                seen.add(rd)
                dirs.append(d)
    return dirs


def load_recipes() -> dict[str, dict]:
    """Recipe/preset library (YAML files; reference backend/config/recipes)."""
    import yaml as _yaml

    out: dict[str, dict] = {}
    for d in _recipe_dirs():
        for f in sorted(d.glob("*.yaml")):
            try:
                data = _yaml.safe_load(f.read_text()) or {}
            except Exception:
                continue
            out.setdefault(f.stem, {"id": f.stem, "source": d.name, **data})
    return out


def build_router(state: AppState) -> Router:
    r = Router()
    v1 = "/api/v1"

    # ---- devices ----
    @r.get(v1 + "/devices")
    async def devices(req: Request) -> Response:
        nicks = state.nicknames
        return Response.json(
            [
                {
                    "id": d.id,
                    "driver": d.driver,
                    "label": d.label,
                    "serial": d.serial,
                    "nickname": nicks.get(d.id),
                }
                for d in state.captures.list_devices()
            ]
        )

    @r.put(v1 + "/devices/{did}/nickname")
    async def device_nickname_set(req: Request) -> Response:
        """Persist a user nickname for a device (reference device naming)."""
        nick = (req.json() or {}).get("nickname")
        state.set_nickname(req.params["did"], nick)
        return Response.json({"id": req.params["did"], "nickname": nick})

    @r.get(v1 + "/devices/health")
    async def devices_health(req: Request) -> Response:
        """Driver/service recovery status + per-capture health (reference
        api.py:1098 sdrplay health endpoints)."""
        return Response.json(
            {
                "recovery": state.recovery.status(),
                "usbPowerCycle": {"available": state.usb.available()},
                "captures": [
                    {
                        "id": c.id,
                        "state": c.state,
                        "error": c.error,
                        "restartCount": c.restart_count,
                        "overflowCount": c.overflow_count,
                        "lastBlockAge": (
                            round(time.time() - c.last_block_time, 1)
                            if c.last_block_time
                            else None
                        ),
                    }
                    for c in state.captures.captures.values()
                ],
            }
        )

    @r.post(v1 + "/devices/service/restart")
    async def device_service_restart(req: Request) -> Response:
        """Restart the SDR driver service (cooldown + hourly caps apply;
        reference api.py sdrplay restart)."""
        result = await asyncio.to_thread(state.recovery.restart_service)
        status = 200 if result.get("ok") else 429
        return Response.json(result, status=status)

    @r.get(v1 + "/devices/usb/hubs")
    async def usb_hubs(req: Request) -> Response:
        if not state.usb.available():
            raise HttpError(501, "uhubctl not installed")
        return Response.json(await asyncio.to_thread(state.usb.list_hubs))

    @r.get(v1 + "/devices/{did}/name")
    async def device_name_get(req: Request) -> Response:
        """Reference path alias for the nickname store."""
        did = req.params["did"]
        return Response.json({"id": did, "nickname": state.nicknames.get(did)})

    # PATCH name == PUT nickname (reference path alias)
    r.patch(v1 + "/devices/{did}/name")(device_nickname_set)

    @r.post(v1 + "/devices/refresh")
    async def devices_refresh(req: Request) -> Response:
        """Re-enumerate SDR hardware (reference POST /devices/refresh)."""
        devices = await asyncio.to_thread(state.captures.list_devices)
        return Response.json(
            {"count": len(devices), "devices": [d.id for d in devices]}
        )

    @r.post(v1 + "/devices/usb/power-cycle")
    async def usb_power_cycle(req: Request) -> Response:
        """Power-cycle a USB port (reference uhubctl.py integration)."""
        if not state.usb.available():
            raise HttpError(501, "uhubctl not installed")
        body = req.json()
        result = await asyncio.to_thread(
            state.usb.power_cycle,
            str(body["hub"]),
            str(body["port"]),
            float(body.get("delaySeconds", 2.0)),
        )
        return Response.json(result)

    @r.post(v1 + "/devices/usb/power-cycle-all")
    async def usb_power_cycle_all(req: Request) -> Response:
        """Power-cycle every detected SDR hub port (reference
        POST /devices/usb/power-cycle-all)."""
        if not state.usb.available():
            raise HttpError(501, "uhubctl not installed")
        delay = float((req.json() or {}).get("delaySeconds", 2.0))
        hubs = await asyncio.to_thread(state.usb.list_hubs)
        results = []
        for hub in hubs:
            for port in hub.get("ports", []):
                results.append(
                    await asyncio.to_thread(
                        state.usb.power_cycle, hub["hub"], str(port["port"]), delay
                    )
                )
        return Response.json({"cycled": len(results), "results": results})

    # reference path aliases (api.py /devices/sdrplay/*)
    r.get(v1 + "/devices/sdrplay/health")(devices_health)
    r.post(v1 + "/devices/sdrplay/restart-service")(device_service_restart)

    # ---- captures ----
    @r.get(v1 + "/captures")
    async def captures_list(req: Request) -> Response:
        return Response.json([capture_json(c) for c in state.captures.captures.values()])

    @r.post(v1 + "/captures")
    async def captures_create(req: Request) -> Response:
        body = req.json()
        try:
            cap = state.captures.create_capture(
                device_id=body.get("deviceId"),
                config=CaptureConfig(
                    center_hz=float(body.get("centerHz", 100e6)),
                    sample_rate=int(body.get("sampleRate", 2_400_000)),
                    gain_db=body.get("gainDb"),
                    ppm=float(body.get("ppm", 0.0)),
                    bandwidth_hz=body.get("bandwidthHz"),
                    antenna=body.get("antenna"),
                    agc=bool(body.get("agc", False)),
                    mesh=body.get("mesh", state.config.stream.mesh),
                    transport=str(
                        body.get("transport", state.config.stream.transport)
                    ),
                    adaptive_transport=bool(
                        body.get(
                            "adaptiveTransport",
                            state.config.stream.adaptive_transport,
                        )
                    ),
                    audio_fetch_slots=int(
                        body.get(
                            "audioFetchSlots",
                            state.config.stream.audio_fetch_slots,
                        )
                    ),
                    narrow_capacity=state.config.limits.max_channels_per_capture,
                    wide_capacity=state.config.limits.max_wide_channels,
                    p25_capacity=state.config.limits.max_p25_channels,
                    p25p2_capacity=state.config.limits.max_p25p2_channels,
                    audio_rate=state.config.stream.audio_rate,
                ),
            )
        except RuntimeError as e:
            raise HttpError(409, str(e))
        STATE_BROADCASTER.publish("capture", cap.id, "created", capture_json(cap))
        if body.get("autoStart", False):
            cap.start()
        return Response.json(capture_json(cap), status=201)

    @r.get(v1 + "/captures/{cid}")
    async def capture_get(req: Request) -> Response:
        return Response.json(capture_json(state.get_capture(req.params["cid"])))

    @r.delete(v1 + "/captures/{cid}")
    async def capture_delete(req: Request) -> Response:
        state.get_capture(req.params["cid"])
        state.captures.remove_capture(req.params["cid"])
        STATE_BROADCASTER.publish("capture", req.params["cid"], "deleted")
        return Response.json({"ok": True})

    @r.post(v1 + "/captures/{cid}/start")
    async def capture_start(req: Request) -> Response:
        cap = state.get_capture(req.params["cid"])
        await asyncio.to_thread(cap.start)
        return Response.json(capture_json(cap))

    @r.post(v1 + "/captures/{cid}/stop")
    async def capture_stop(req: Request) -> Response:
        cap = state.get_capture(req.params["cid"])
        await asyncio.to_thread(cap.stop)
        return Response.json(capture_json(cap))

    @r.post(v1 + "/captures/{cid}/restart")
    async def capture_restart(req: Request) -> Response:
        cap = state.get_capture(req.params["cid"])
        await asyncio.to_thread(cap.restart)
        return Response.json(capture_json(cap))

    @r.get(v1 + "/captures/{cid}/spectrum")
    async def capture_spectrum(req: Request) -> Response:
        cap = state.get_capture(req.params["cid"])
        spec = getattr(cap, "last_spectrum", None)
        if spec is None:
            # stop()/retune invalidates the cache (round 5: a stopped
            # capture must not serve stale data, a retuned one must not
            # serve old-frequency frames under the new label) — and a
            # stopped capture will never publish a fresh frame, so answer
            # immediately instead of burning the 10 s wait
            if cap.state != "running":
                raise HttpError(404, "no spectrum available (capture stopped)")
            # No frame yet (capture just started): wait for the first one.
            sub = cap.spectrum_subs.subscribe(maxsize=2)
            try:
                spec = await asyncio.to_thread(sub.get, 10.0)
            except Exception:
                raise HttpError(404, "no spectrum available (capture running?)")
            finally:
                sub.close()
        frame = spec[-1] if spec.ndim == 2 else spec
        return Response.json(
            {
                "captureId": cap.id,
                "centerHz": cap.config.center_hz,
                "sampleRate": cap.config.sample_rate,
                "db": [round(float(x), 1) for x in frame],
            }
        )

    r.get(v1 + "/captures/{cid}/spectrum/snapshot")(capture_spectrum)

    @r.get(v1 + "/captures/{cid}/channels")
    async def capture_channels(req: Request) -> Response:
        """Channels of one capture (reference GET /captures/{cid}/channels;
        also embedded in the capture status)."""
        cap = state.get_capture(req.params["cid"])
        return Response.json(
            [channel_json(cap, ch) for ch in cap.channels.values()]
        )

    @r.get(v1 + "/captures/{cid}/classified-channels")
    async def capture_classified(req: Request) -> Response:
        """Channels the activity classifier found in the capture span
        (reference api.py /classified-channels <- channel_classifier)."""
        cap = state.get_capture(req.params["cid"])
        from dataclasses import asdict

        min_occ = float(req.query.get("minOccupancy", "0.3"))
        return Response.json(
            {
                "captureId": cap.id,
                "frames": cap.classifier.frames,
                "channels": [
                    asdict(c) for c in cap.classifier.classify(min_occupancy=min_occ)
                ],
            }
        )

    @r.patch(v1 + "/captures/{cid}")
    async def capture_update(req: Request) -> Response:
        """Retune a running capture (reference api.py update_capture)."""
        cap = state.get_capture(req.params["cid"])
        body = req.json()
        await asyncio.to_thread(
            cap.update_config,
            center_hz=body.get("centerHz"),
            gain_db=body.get("gainDb"),
            sample_rate=body.get("sampleRate"),
            ppm=body.get("ppm"),
            bandwidth_hz=body.get("bandwidthHz"),
            antenna=body.get("antenna"),
            agc=body.get("agc"),
        )
        STATE_BROADCASTER.publish("capture", cap.id, "updated", capture_json(cap))
        return Response.json(capture_json(cap))

    # ---- channels ----
    @r.get(v1 + "/channels")
    async def channels_all(req: Request) -> Response:
        out = []
        for cap in state.captures.captures.values():
            out += [channel_json(cap, c) for c in cap.channels.values()]
        return Response.json(out)

    @r.post(v1 + "/captures/{cid}/channels")
    async def channel_create(req: Request) -> Response:
        cap = state.get_capture(req.params["cid"])
        body = req.json()
        cid = body.get("id") or state.new_channel_id()
        try:
            ch = cap.create_channel(
                ChannelSpec(
                    id=cid,
                    mode=body.get("mode", "nbfm"),
                    frequency_hz=float(body["frequencyHz"]),
                    squelch_db=body.get("squelchDb"),
                    name=body.get("name", ""),
                    dsp={k: v for k, v in (dsp_from_body(body) or {}).items()
                         if v is not None},
                )
            )
        except KeyError:
            raise HttpError(422, "frequencyHz required")
        except ValueError as e:
            raise HttpError(422, str(e))
        except RuntimeError as e:
            raise HttpError(409, str(e))
        STATE_BROADCASTER.publish("channel", cid, "created", channel_json(cap, ch))
        return Response.json(channel_json(cap, ch), status=201)

    @r.get(v1 + "/channels/{chid}")
    async def channel_get(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        return Response.json(channel_json(cap, ch))

    @r.patch(v1 + "/channels/{chid}")
    async def channel_update(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        body = req.json()
        kw: dict = {}
        if "frequencyHz" in body:
            kw["frequency_hz"] = body["frequencyHz"]
        if "squelchDb" in body:  # explicit null = open squelch
            kw["squelch_db"] = body["squelchDb"]
        if "name" in body:
            kw["name"] = body["name"]
        if "mode" in body:
            kw["mode"] = body["mode"]
        dsp = dsp_from_body(body)
        if dsp is not None:
            kw["dsp"] = dsp
        try:
            cap.update_channel(ch.id, **kw)
        except ValueError as e:
            raise HttpError(422, str(e))
        except RuntimeError as e:
            raise HttpError(409, str(e))
        STATE_BROADCASTER.publish("channel", ch.id, "updated", channel_json(cap, ch))
        return Response.json(channel_json(cap, ch))

    @r.delete(v1 + "/channels/{chid}")
    async def channel_delete(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        cap.remove_channel(ch.id)
        STATE_BROADCASTER.publish("channel", ch.id, "deleted")
        return Response.json({"ok": True})

    @r.get(v1 + "/channels/{chid}/metrics")
    async def channel_metrics(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        out = {
            "id": ch.id,
            "rssiDb": round(ch.rssi_db, 1),
            "audioSubscribers": ch.audio.count,
        }
        if req.query.get("history"):
            out["history"] = [
                {"time": t, "rssiDb": v} for t, v in ch.rssi_history
            ]
        return Response.json(out)

    @r.get(v1 + "/channels/{chid}/metrics/history")
    async def channel_metrics_history(req: Request) -> Response:
        """RSSI over time (reference GET .../metrics/history)."""
        cap, ch = state.find_channel(req.params["chid"])
        limit = int(req.query.get("limit", "300"))
        return Response.json(
            [{"time": t, "rssiDb": v} for t, v in ch.rssi_history[-limit:]]
        )

    @r.get(v1 + "/channels/{chid}/metrics/extended")
    async def channel_metrics_extended(req: Request) -> Response:
        """Extended metrics incl. stream fan-out and attachment state
        (reference GET .../metrics/extended)."""
        cap, ch = state.find_channel(req.params["chid"])
        hist = [v for _, v in ch.rssi_history[-60:]]
        return Response.json(
            {
                "id": ch.id,
                "captureId": cap.id,
                "state": ch.state,
                "rssiDb": round(ch.rssi_db, 1),
                "rssiMeanDb": round(float(np.mean(hist)), 1) if hist else None,
                "rssiPeakDb": round(float(np.max(hist)), 1) if hist else None,
                "audioSubscribers": ch.audio.count,
                "symbolSubscribers": ch.symbols.count,
                "basebandSubscribers": ch.baseband.count,
                "squelchDb": ch.spec.squelch_db,
                "attachments": [
                    k for (cid, k) in state.attachments if cid == ch.id
                ],
            }
        )

    @r.post(v1 + "/channels/{chid}/start")
    async def channel_start(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        ch.state = "active"
        return Response.json(channel_json(cap, ch))

    @r.post(v1 + "/channels/{chid}/stop")
    async def channel_stop(req: Request) -> Response:
        """Stop publishing a channel's streams without freeing its slot
        (reference POST /channels/{id}/stop)."""
        cap, ch = state.find_channel(req.params["chid"])
        ch.state = "stopped"
        return Response.json(channel_json(cap, ch))

    @r.get(v1 + "/channels/{chid}/decode/pocsag")
    async def channel_decode_pocsag(req: Request) -> Response:
        """POCSAG messages only (reference GET .../decode/pocsag; the
        generic feed is GET .../messages)."""
        cap, ch = state.find_channel(req.params["chid"])
        att = state.attachments.get((ch.id, "pocsag"))
        msgs = list(att.messages) if att is not None else []
        aliases = state.config.pocsag_aliases
        out = []
        for m in msgs[-int(req.query.get("limit", "100")):]:
            entry = dict(m)
            if m.get("address") in aliases:
                entry["alias"] = aliases[m["address"]]
            out.append(entry)
        return Response.json(out)

    @r.get(v1 + "/channels/{chid}/decode/flex")
    async def channel_decode_flex(req: Request) -> Response:
        """FLEX messages only (reference GET .../decode/flex,
        reference ``api.py``; the generic feed is GET .../messages)."""
        cap, ch = state.find_channel(req.params["chid"])
        att = state.attachments.get((ch.id, "flex"))
        msgs = list(att.messages) if att is not None else []
        return Response.json(msgs[-int(req.query.get("limit", "100")):])

    # ---- frequency identify / recipes ----
    @r.get(v1 + "/frequencies/identify")
    async def freq_identify(req: Request) -> Response:
        from wavecap_tpu_torch.utils import namers

        try:
            hz = float(req.query["hz"])
        except (KeyError, ValueError):
            raise HttpError(422, "hz query parameter required")
        band = namers.band_for(hz)
        return Response.json(
            {
                "frequencyHz": hz,
                "name": namers.frequency_name(hz),
                "band": band.name if band else None,
                "modeHint": namers.mode_hint(hz),
            }
        )

    r.get(v1 + "/frequency/identify")(freq_identify)  # reference path alias

    @r.get(v1 + "/recipes")
    async def recipes(req: Request) -> Response:
        return Response.json(list(load_recipes().values()))

    @r.post(v1 + "/recipes/{rid}/apply")
    async def recipe_apply(req: Request) -> Response:
        """Instantiate a recipe: capture + channels (+ trunking system).

        Body (all optional): {"start": bool, "deviceId": str,
        "frequencyHz": float} — frequencyHz re-centers single-channel
        recipes on a user-supplied frequency (reference recipes'
        allow_frequency_input behavior).
        """
        rec = load_recipes().get(req.params["rid"])
        if rec is None:
            raise HttpError(404, "unknown recipe")
        body = req.json() if req.body else {}
        cap_spec = rec.get("capture") or {}
        center = float(cap_spec.get("center_hz", 100e6))
        user_freq = body.get("frequencyHz")
        shift = float(user_freq) - center if user_freq is not None else 0.0
        try:
            cap = state.captures.create_capture(
                device_id=body.get("deviceId"),
                config=CaptureConfig(
                    center_hz=center + shift,
                    sample_rate=int(float(cap_spec.get("sample_rate", 2_400_000))),
                    gain_db=cap_spec.get("gain_db"),
                    ppm=float(cap_spec.get("ppm", 0.0)),
                    bandwidth_hz=cap_spec.get("bandwidth_hz"),
                    antenna=cap_spec.get("antenna"),
                    agc=bool(cap_spec.get("agc", False)),
                    narrow_capacity=state.config.limits.max_channels_per_capture,
                    wide_capacity=state.config.limits.max_wide_channels,
                    p25_capacity=state.config.limits.max_p25_channels,
                    p25p2_capacity=state.config.limits.max_p25p2_channels,
                    audio_rate=state.config.stream.audio_rate,
                    audio_fetch_slots=state.config.stream.audio_fetch_slots,
                ),
            )
        except RuntimeError as e:
            raise HttpError(409, str(e))
        chans = []
        for c in rec.get("channels") or []:
            try:
                ch = cap.create_channel(
                    ChannelSpec(
                        id=state.new_channel_id(),
                        mode=c.get("mode", "nbfm"),
                        frequency_hz=float(c.get("frequency_hz", center)) + shift,
                        squelch_db=c.get("squelch_db"),
                        name=c.get("name", ""),
                        dsp={
                            k: tuple(v) if isinstance(v, list) else v
                            for k, v in (c.get("dsp") or {}).items()
                        },
                    )
                )
                chans.append(channel_json(cap, ch))
            except (ValueError, RuntimeError) as e:
                logger.warning("recipe channel skipped: %s", e)
        tr = rec.get("trunking")
        tsys_id = None
        if tr:
            tdict = dict(tr)
            tsys_id = tdict.setdefault("id", f"{req.params['rid']}-trunk")
            tdict.setdefault("sample_rate", int(float(cap_spec.get("sample_rate", 2_400_000))))
            try:
                if state.trunking_workers is not None:
                    state.trunking_workers.add_system(tdict)
                else:
                    tcfg = TrunkingSystemConfig.from_dict(tdict)
                    state.trunking.create_system(tcfg)
            except Exception as e:
                logger.warning("recipe trunking skipped: %s", e)
                tsys_id = None
        if body.get("start", False):
            cap.start()
        STATE_BROADCASTER.publish("capture", cap.id, "created", capture_json(cap))
        return Response.json(
            {"capture": capture_json(cap), "channels": chans,
             "trunkingSystemId": tsys_id},
            status=201,
        )

    # ---- config / system ----
    @r.get(v1 + "/config")
    async def config_get(req: Request) -> Response:
        from dataclasses import asdict

        return Response.json(asdict(state.config))

    @r.post(v1 + "/config/reload")
    async def config_reload(req: Request) -> Response:
        path = state.config.config_paths[0] if state.config.config_paths else None
        new_cfg = config_mod.load_config(path)
        state.config = new_cfg
        applied = False
        if (req.json() or {}).get("apply"):
            # reference semantics: restart captures from YAML (api.py:743)
            await asyncio.to_thread(state.captures.stop_all)
            for cid in list(state.captures.captures):
                state.captures.remove_capture(cid)
            await asyncio.to_thread(state.apply_config)
            applied = True
        return Response.json(
            {"ok": True, "paths": new_cfg.config_paths, "applied": applied}
        )

    @r.get(v1 + "/system/metrics")
    async def sys_metrics(req: Request) -> Response:
        m = system_metrics()
        m["captures"] = {
            c.id: {
                "blocksProcessed": c.blocks_processed,
                "blockMs": round(c.block_ms, 2),
                "overflowCount": c.overflow_count,
            }
            for c in state.captures.captures.values()
        }
        m["errorRates"] = ERROR_TRACKER.rates()
        m["uptimeS"] = round(time.time() - state.started_at, 1)
        return Response.json(m)

    @r.get(v1 + "/debug/perf")
    async def perf(req: Request) -> Response:
        return Response.json(
            {
                c.id: {"blockMs": round(c.block_ms, 2), "blockSize": c.block_size}
                for c in state.captures.captures.values()
            }
        )

    @r.get(v1 + "/errors")
    async def errors(req: Request) -> Response:
        return Response.json(
            [
                {"time": e.time, "kind": e.kind, "source": e.source, "message": e.message}
                for e in ERROR_TRACKER.recent(int(req.query.get("limit", "100")))
            ]
        )

    @r.get(v1 + "/logs")
    async def logs(req: Request) -> Response:
        return Response.json(LOG_RING.tail(int(req.query.get("limit", "200"))))

    # ---- frontend log ingestion (reference api.py /frontend-logs +
    # /log/frontend: browser clients ship their console errors here) ----

    @r.post(v1 + "/frontend-logs")
    async def frontend_logs_post(req: Request) -> Response:
        body = req.json()
        entries = body if isinstance(body, list) else [body or {}]
        for e in entries[:100]:
            state.frontend_logs.append(
                {
                    "time": time.time(),
                    "level": str(e.get("level", "info"))[:16],
                    "message": str(e.get("message", ""))[:2000],
                    "source": str(e.get("source", "frontend"))[:128],
                }
            )
        return Response.json({"ok": True, "count": len(state.frontend_logs)})

    @r.get(v1 + "/frontend-logs")
    async def frontend_logs_get(req: Request) -> Response:
        limit = int(req.query.get("limit", "200"))
        return Response.json(list(state.frontend_logs)[-limit:])

    @r.delete(v1 + "/frontend-logs")
    async def frontend_logs_clear(req: Request) -> Response:
        n = len(state.frontend_logs)
        state.frontend_logs.clear()
        return Response.json({"cleared": n})

    # reference also mounts the same store at /log/frontend and POST /logs
    r.post(v1 + "/log/frontend")(frontend_logs_post)
    r.get(v1 + "/log/frontend")(frontend_logs_get)
    r.delete(v1 + "/log/frontend")(frontend_logs_clear)
    r.post(v1 + "/logs")(frontend_logs_post)

    @r.post(v1 + "/shutdown")
    async def shutdown(req: Request) -> Response:
        """Graceful server shutdown (reference POST /shutdown)."""
        loop = asyncio.get_running_loop()

        def _later():
            state.shutdown_requested = True
            if state.on_shutdown_request is not None:
                state.on_shutdown_request()

        loop.call_later(0.2, _later)  # let the response flush first
        return Response.json({"ok": True, "shuttingDown": True})

    # ---- trunking ----
    def _get_system(req: Request):
        try:
            return state.trunking.get(req.params["sid"])
        except KeyError:
            raise HttpError(404)

    @r.get(v1 + "/trunking/systems")
    async def tk_systems(req: Request) -> Response:
        out = state.trunking.status()
        if state.trunking_workers is not None:
            for w in state.trunking_workers.status():
                out += w.get("systems") or []
        return Response.json(out)

    @r.get(v1 + "/trunking/workers")
    async def tk_workers(req: Request) -> Response:
        if state.trunking_workers is None:
            return Response.json([])
        return Response.json(state.trunking_workers.status())

    @r.post(v1 + "/trunking/systems")
    async def tk_create(req: Request) -> Response:
        body = req.json()
        try:
            cfg = TrunkingSystemConfig.from_dict(body)
            sys_ = state.trunking.create_system(cfg)
        except (KeyError, ValueError) as e:
            raise HttpError(422, str(e))
        if body.get("autoStart", False):
            await asyncio.to_thread(sys_.start)
        return Response.json(sys_.status(), status=201)

    @r.get(v1 + "/trunking/systems/{sid}")
    async def tk_get(req: Request) -> Response:
        try:
            return Response.json(state.trunking.get(req.params["sid"]).status())
        except KeyError:
            raise HttpError(404)

    @r.delete(v1 + "/trunking/systems/{sid}")
    async def tk_delete(req: Request) -> Response:
        state.trunking.remove_system(req.params["sid"])
        return Response.json({"ok": True})

    @r.post(v1 + "/trunking/systems/{sid}/start")
    async def tk_start(req: Request) -> Response:
        sys_ = _get_system(req)
        await asyncio.to_thread(sys_.start)
        return Response.json(sys_.status())

    @r.post(v1 + "/trunking/systems/{sid}/stop")
    async def tk_stop(req: Request) -> Response:
        sys_ = _get_system(req)
        await asyncio.to_thread(sys_.stop)
        return Response.json(sys_.status())

    @r.get(v1 + "/trunking/systems/{sid}/talkgroups")
    async def tk_talkgroups(req: Request) -> Response:
        sys_ = _get_system(req)
        return Response.json(
            [
                {
                    "tgid": t.tgid,
                    "name": t.name,
                    "category": t.category,
                    "priority": t.priority,
                    "record": t.record,
                    "monitor": t.monitor,
                }
                for t in sys_.config.talkgroups.values()
            ]
        )

    def _tg_from_dict(d: dict) -> TalkgroupConfig:
        return TalkgroupConfig(
            tgid=int(d["tgid"]),
            name=str(d.get("name", "")),
            category=str(d.get("category", "")),
            priority=int(d.get("priority", 5)),
            record=bool(d.get("record", True)),
            monitor=bool(d.get("monitor", True)),
        )

    @r.put(v1 + "/trunking/systems/{sid}/talkgroups")
    async def tk_talkgroups_put(req: Request) -> Response:
        """Replace (or merge into) the live talkgroup directory.  Recorders
        consult ``config.talkgroup(tgid)`` per call, so edits apply to the
        next grant without a restart (reference trunking/api.py talkgroup
        update path)."""
        sys_ = _get_system(req)
        body = req.json()
        items = body if isinstance(body, list) else body.get("talkgroups", [])
        merge = isinstance(body, dict) and bool(body.get("merge"))
        try:
            tgs = {int(t["tgid"]): _tg_from_dict(t) for t in items}
        except (KeyError, TypeError, ValueError) as e:
            raise HttpError(422, f"bad talkgroup entry: {e}")
        if merge:
            sys_.config.talkgroups.update(tgs)
        else:
            sys_.config.talkgroups = tgs
        return Response.json({"ok": True, "count": len(sys_.config.talkgroups)})

    @r.patch(v1 + "/trunking/systems/{sid}/talkgroups/{tgid}")
    async def tk_talkgroup_patch(req: Request) -> Response:
        try:
            sys_ = state.trunking.get(req.params["sid"])
            tgid = int(req.params["tgid"])
        except KeyError:
            raise HttpError(404)
        except ValueError:
            raise HttpError(422, "tgid must be an integer")
        tg = sys_.config.talkgroups.get(tgid)
        if tg is None:
            tg = sys_.config.talkgroup(tgid)  # materialize the default
            sys_.config.talkgroups[tgid] = tg
        body = req.json() or {}
        for field_name in ("name", "category"):
            if field_name in body:
                setattr(tg, field_name, str(body[field_name]))
        if "priority" in body:
            tg.priority = int(body["priority"])
        for flag in ("record", "monitor"):
            if flag in body:
                setattr(tg, flag, bool(body[flag]))
        return Response.json(
            {
                "tgid": tg.tgid, "name": tg.name, "category": tg.category,
                "priority": tg.priority, "record": tg.record,
                "monitor": tg.monitor,
            }
        )

    @r.post(v1 + "/trunking/systems/{sid}/talkgroups")
    async def tk_talkgroups_post(req: Request) -> Response:
        """Add/update talkgroups (merge semantics — reference POST
        .../talkgroups)."""
        sys_ = _get_system(req)
        body = req.json()
        items = body if isinstance(body, list) else [body or {}]
        try:
            for t in items:
                sys_.config.talkgroups[int(t["tgid"])] = _tg_from_dict(t)
        except (KeyError, TypeError, ValueError) as e:
            raise HttpError(422, f"bad talkgroup entry: {e}")
        return Response.json(
            {"ok": True, "count": len(sys_.config.talkgroups)}, status=201
        )

    @r.post(v1 + "/trunking/systems/{sid}/talkgroups/import")
    async def tk_talkgroups_import(req: Request) -> Response:
        """Import a RadioReference-style CSV (body ``{"csv": "..."}``);
        merges into the live directory (reference config.py
        load_talkgroups_csv)."""
        from wavecap_tpu_torch.trunking.config import parse_talkgroups_csv

        sys_ = _get_system(req)
        text = (req.json() or {}).get("csv", "")
        if not text.strip():
            raise HttpError(422, "csv body required")
        tgs = parse_talkgroups_csv(text.splitlines())
        sys_.config.talkgroups.update(tgs)
        return Response.json(
            {"ok": True, "imported": len(tgs),
             "count": len(sys_.config.talkgroups)}
        )

    @r.get(v1 + "/trunking/calls")
    async def tk_all_calls(req: Request) -> Response:
        """Active calls across every system (reference trunking/api.py
        GET /calls)."""
        out = []
        for sys_ in state.trunking.systems.values():
            for c in sys_.status()["activeCalls"]:
                out.append({"systemId": sys_.config.id, **c})
        return Response.json(out)

    @r.get(v1 + "/trunking/recipes")
    async def tk_recipes(req: Request) -> Response:
        """Recipes that define a trunking system (reference
        ``trunking/api.py:325+`` GET /trunking/recipes)."""
        return Response.json(
            [rec for rec in load_recipes().values() if rec.get("trunking")]
        )

    @r.get(v1 + "/trunking/vocoders")
    async def tk_vocoders(req: Request) -> Response:
        """Vocoder availability (reference GET /vocoders).  Both rates are
        always available here: the native MBE synthesizers need no
        external binary; libmbe upgrades the IMBE path when installed."""
        from wavecap_tpu_torch.decoders.voice import vocoder_backend

        return Response.json(
            {
                "imbe": True,
                "ambe2": True,
                "anyAvailable": True,
                "imbeBackend": vocoder_backend(),
                "ambe2Backend": "native",
            }
        )

    @r.get(v1 + "/trunking/systems/{sid}/hunt-mode")
    async def tk_hunt_mode_get(req: Request) -> Response:
        sys_ = _get_system(req)
        return Response.json({"huntMode": sys_.config.hunt_mode.value})

    @r.patch(v1 + "/trunking/systems/{sid}/hunt-mode")
    async def tk_hunt_mode_set(req: Request) -> Response:
        sys_ = _get_system(req)
        mode = (req.json() or {}).get("huntMode")
        try:
            sys_.set_hunt_mode(str(mode))
        except ValueError:
            raise HttpError(422, f"unknown hunt mode {mode!r}")
        return Response.json({"huntMode": sys_.config.hunt_mode.value})

    @r.get(v1 + "/trunking/systems/{sid}/channels")
    async def tk_cc_channels(req: Request) -> Response:
        """Control-channel candidate table with measurements and operator
        overrides (reference GET .../channels)."""
        sys_ = _get_system(req)
        measurements = {
            m["frequencyHz"]: m for m in sys_.scanner.status()
        }
        # full candidate universe, independent of the pin override (which
        # narrows _candidates() to one entry): the operator must still see
        # and manage every configured/learned/disabled CC while pinned
        universe = list(sys_.config.control_channels)
        for site in sys_.adjacent_sites.values():
            f = site.get("frequencyHz")
            if f and f not in universe:
                universe.append(f)
        if sys_.cc_lock_override is not None and (
            sys_.cc_lock_override not in universe
        ):
            universe.append(sys_.cc_lock_override)
        out = []
        for f in universe + sorted(sys_.disabled_ccs):
            if any(c["frequencyHz"] == f for c in out):
                continue
            m = measurements.get(f, {})
            out.append(
                {
                    "frequencyHz": f,
                    "enabled": f not in sys_.disabled_ccs,
                    "locked": sys_.cc_lock_override == f,
                    "current": sys_._cc_current_freq == f,
                    "configured": f in sys_.config.control_channels,
                    **{k: v for k, v in m.items() if k != "frequencyHz"},
                }
            )
        return Response.json(out)

    @r.patch(v1 + "/trunking/systems/{sid}/channels/{freq}/enabled")
    async def tk_cc_enable(req: Request) -> Response:
        sys_ = _get_system(req)
        try:
            freq = float(req.params["freq"])
        except ValueError:
            raise HttpError(422, "freq must be Hz")
        enabled = bool((req.json() or {}).get("enabled", True))
        sys_.set_cc_enabled(freq, enabled)
        return Response.json({"frequencyHz": freq, "enabled": enabled})

    @r.post(v1 + "/trunking/systems/{sid}/channels/{freq}/lock")
    async def tk_cc_lock(req: Request) -> Response:
        """Pin hunting to one CC; body ``{"locked": false}`` clears."""
        sys_ = _get_system(req)
        try:
            freq = float(req.params["freq"])
        except ValueError:
            raise HttpError(422, "freq must be Hz")
        locked = bool((req.json() or {}).get("locked", True))
        sys_.set_cc_lock(freq if locked else None)
        return Response.json({"frequencyHz": freq, "locked": locked})

    @r.post(v1 + "/trunking/systems/{sid}/scan")
    async def tk_scan(req: Request) -> Response:
        """Force re-verification of every CC candidate."""
        sys_ = _get_system(req)
        sys_.trigger_scan()
        return Response.json({"ok": True})

    @r.get(v1 + "/trunking/systems/{sid}/voice-streams")
    async def tk_voice_streams(req: Request) -> Response:
        return Response.json(_get_system(req).voice_streams())

    # ---- call recordings browser (artifact files the recorders write:
    # WAV + metadata JSON + raw .imbe/.ambe codewords) ----

    def _recording_dir(sys_) -> Path:
        # recorders write under recording_dir/<system_id>/ (system.py
        # _end_call), so the browser must look there too
        return Path(sys_.config.recording_dir) / sys_.config.id

    @r.get(v1 + "/trunking/systems/{sid}/recordings")
    async def tk_recordings(req: Request) -> Response:
        sys_ = _get_system(req)
        d = _recording_dir(sys_)
        limit = int(req.query.get("limit", "100"))
        out = []
        if d.is_dir():
            for j in sorted(d.glob("*.json"))[-limit:]:
                try:
                    meta = json.loads(j.read_text())
                except (OSError, ValueError):
                    continue
                base = j.stem
                out.append(
                    {
                        "name": base,
                        "hasAudio": (d / f"{base}.wav").exists(),
                        "hasCodewords": (d / f"{base}.imbe").exists()
                        or (d / f"{base}.ambe").exists(),
                        **meta,
                    }
                )
        out.reverse()  # newest first
        return Response.json(out)

    @r.get(v1 + "/trunking/systems/{sid}/recordings/{name}.wav")
    async def tk_recording_wav(req: Request) -> Response:
        sys_ = _get_system(req)
        name = req.params["name"]
        # artifact names come from the recorder's own stamp pattern; reject
        # anything that could escape the recordings directory
        if not name.replace("_", "").replace("-", "").isalnum():
            raise HttpError(422, "bad recording name")
        path = _recording_dir(sys_) / f"{name}.wav"
        if not path.is_file():
            raise HttpError(404)
        data = await asyncio.to_thread(path.read_bytes)
        return Response(body=data, content_type="audio/wav")

    @r.delete(v1 + "/trunking/systems/{sid}/messages")
    async def tk_messages_clear(req: Request) -> Response:
        sys_ = _get_system(req)
        n = len(sys_.message_log)
        sys_.message_log.clear()
        return Response.json({"cleared": n})

    @r.get(v1 + "/trunking/systems/{sid}/calls")
    async def tk_calls(req: Request) -> Response:
        sys_ = _get_system(req)
        hist = [
            {
                "tgid": c.tgid,
                "talkgroup": c.talkgroup_name,
                "sourceId": c.source_id,
                "frequencyHz": c.frequency_hz,
                "startTime": c.start_time,
                "endTime": c.end_time,
                "imbeFrames": c.imbe_frames,
            }
            for c in list(sys_.call_history)[: int(req.query.get("limit", "50"))]
        ]
        return Response.json(
            {"active": sys_.status()["activeCalls"], "history": hist}
        )

    @r.get(v1 + "/trunking/systems/{sid}/calls/active")
    async def tk_calls_active(req: Request) -> Response:
        """Active calls only (reference GET .../calls/active)."""
        return Response.json(_get_system(req).status()["activeCalls"])

    @r.get(v1 + "/trunking/systems/{sid}/locations")
    async def tk_locations(req: Request) -> Response:
        """LRRP GPS cache (from PDU frames on voice channels)."""
        sys_ = _get_system(req)
        return Response.json(
            [
                {
                    "unitId": l.radio_id,
                    "latitude": l.latitude,
                    "longitude": l.longitude,
                    "altitudeM": l.altitude_m,
                    "speedKmh": l.speed_kmh,
                    "headingDeg": l.heading_deg,
                    "time": l.time,
                }
                for l in sys_.locations.all()
            ]
        )

    @r.get(v1 + "/trunking/systems/{sid}/messages")
    async def tk_messages(req: Request) -> Response:
        sys_ = _get_system(req)
        return Response.json(list(sys_.message_log)[-int(req.query.get("limit", "100")):])

    @r.get(v1 + "/trunking/systems/{sid}/events")
    async def tk_events(req: Request) -> Response:
        sys_ = _get_system(req)
        return Response.json(list(sys_.events)[-int(req.query.get("limit", "100")):])

    # ---- WebSocket streams ----
    @r.websocket(v1 + "/stream/captures/{cid}/spectrum")
    async def ws_spectrum(req: Request, ws: WebSocket) -> None:
        cap = state.get_capture(req.params["cid"])
        sub = cap.spectrum_subs.subscribe(maxsize=4)

        async def send(spec) -> None:
            frame = spec[-1] if spec.ndim == 2 else spec
            await ws.send_json(
                {
                    "type": "spectrum",
                    "centerHz": cap.config.center_hz,
                    "sampleRate": cap.config.sample_rate,
                    "db": [round(float(x), 1) for x in frame],
                }
            )

        try:
            # Instant first paint: replay the cached last frame on connect
            # instead of making the client wait out an FPS interval (or a
            # bank-change rebuild) for the next published one.
            cached = getattr(cap, "last_spectrum", None)
            if cached is not None:
                await send(cached)
            while not ws.closed:
                spec = await _sub_get(sub, ws)
                if spec is cached:
                    # the replayed cached frame was still queued for this
                    # subscriber — don't double-paint it
                    cached = None
                    continue
                cached = None
                await send(spec)
        finally:
            sub.close()

    @r.websocket(v1 + "/stream/captures/{cid}/iq")
    async def ws_iq(req: Request, ws: WebSocket) -> None:
        cap = state.get_capture(req.params["cid"])
        sub = cap.iq_subs.subscribe(maxsize=4)
        try:
            while not ws.closed:
                iq = await _sub_get(sub, ws)
                await ws.send_bytes(pack_iq16(iq).tobytes())
        finally:
            sub.close()

    @r.websocket(v1 + "/stream/channels/{chid}")
    async def ws_audio(req: Request, ws: WebSocket) -> None:
        cap, ch = state.find_channel(req.params["chid"])
        fmt = req.query.get("format", "pcm16")
        from .encoders import available_formats, make_encoder

        if fmt not in available_formats():
            await ws.send_json({"error": f"format {fmt} unavailable"})
            return
        encoder = make_encoder(fmt, state.config.stream.audio_rate)
        sub = ch.audio.subscribe(maxsize=16)
        try:
            while not ws.closed:
                audio = await _sub_get(sub, ws)
                data = encoder.encode(audio)
                if data:
                    await ws.send_bytes(data)
        finally:
            sub.close()
            encoder.close()

    @r.websocket(v1 + "/stream/state")
    async def ws_state(req: Request, ws: WebSocket) -> None:
        q: asyncio.Queue = asyncio.Queue(maxsize=100)
        loop = asyncio.get_running_loop()

        def cb(evt):
            try:
                loop.call_soon_threadsafe(q.put_nowait, evt)
            except RuntimeError:
                pass

        cancel = STATE_BROADCASTER.subscribe(cb)
        try:
            while not ws.closed:
                evt = await q.get()
                await ws.send_json(evt)
        finally:
            cancel()

    @r.websocket(v1 + "/stream/health")
    async def ws_health(req: Request, ws: WebSocket) -> None:
        while not ws.closed:
            await ws.send_json(
                {
                    "type": "health",
                    "time": time.time(),
                    "captures": {
                        c.id: c.state for c in state.captures.captures.values()
                    },
                    "errorRates": ERROR_TRACKER.rates(),
                }
            )
            await asyncio.sleep(2.0)

    @r.websocket(v1 + "/stream/system")
    async def ws_system(req: Request, ws: WebSocket) -> None:
        """System metrics snapshots every 2 s (reference WS /stream/system)."""
        while not ws.closed:
            m = system_metrics()
            m["type"] = "system"
            m["time"] = time.time()
            m["captures"] = {
                c.id: {
                    "state": c.state,
                    "blocksProcessed": c.blocks_processed,
                    "blockMs": round(c.block_ms, 2),
                }
                for c in state.captures.captures.values()
            }
            await ws.send_json(m)
            await asyncio.sleep(2.0)

    @r.websocket(v1 + "/stream/logs")
    async def ws_logs(req: Request, ws: WebSocket) -> None:
        q: asyncio.Queue = asyncio.Queue(maxsize=200)
        loop = asyncio.get_running_loop()
        cancel = LOG_RING.subscribe(
            lambda e: loop.call_soon_threadsafe(_safe_put, q, e)
        )
        try:
            for entry in LOG_RING.tail(100):
                await ws.send_json(entry)
            while not ws.closed:
                await ws.send_json(await q.get())
        finally:
            cancel()

    @r.websocket(v1 + "/trunking/stream")
    async def ws_trunking(req: Request, ws: WebSocket) -> None:
        q: asyncio.Queue = asyncio.Queue(maxsize=200)
        loop = asyncio.get_running_loop()

        def cb(evt):
            loop.call_soon_threadsafe(_safe_put, q, evt)

        state._trunking_event_subs.add(cb)
        try:
            while not ws.closed:
                await ws.send_json(await q.get())
        finally:
            state._trunking_event_subs.discard(cb)

    @r.websocket(v1 + "/trunking/stream/{sid}")
    async def ws_trunking_one(req: Request, ws: WebSocket) -> None:
        """Events of ONE system (reference WS /trunking/stream/{id})."""
        sid = req.params["sid"]
        q: asyncio.Queue = asyncio.Queue(maxsize=200)
        loop = asyncio.get_running_loop()

        def cb(evt):
            if evt.get("systemId") in (None, sid):
                loop.call_soon_threadsafe(_safe_put, q, evt)

        state._trunking_event_subs.add(cb)
        try:
            while not ws.closed:
                await ws.send_json(await q.get())
        finally:
            state._trunking_event_subs.discard(cb)

    async def _pump_voice(ws: WebSocket, subs: list) -> None:
        try:
            while not ws.closed:
                sent = False
                for sub in subs:
                    pcm = sub.get_nowait()
                    if pcm is not None:
                        await ws.send_bytes(pack_pcm16(pcm).tobytes())
                        sent = True
                if not sent:
                    await asyncio.sleep(0.05)
        finally:
            for sub in subs:
                sub.close()

    def _worker_system_ids() -> set:
        """System ids hosted by worker processes (per-device mode)."""
        ids: set = set()
        tw = state.trunking_workers
        if tw is None:
            return ids
        for cfg_ in tw.system_configs:
            ids.add(str(cfg_.get("id", "")))
        for systems in tw.latest_status.values():
            for s_ in systems:
                ids.add(str(s_.get("id", "")))
        return ids

    async def _pump_worker_voice(ws: WebSocket, sub) -> None:
        try:
            while not ws.closed:
                pcm = sub.get_nowait()
                if pcm is not None:
                    await ws.send_bytes(pcm)
                else:
                    await asyncio.sleep(0.05)
        finally:
            sub.close()

    def _worker_voice_response(sub) -> Response:
        async def gen():
            try:
                while True:
                    pcm = sub.get_nowait()
                    if pcm is not None:
                        yield pcm
                    else:
                        yield b""  # liveness probe tick
                        await asyncio.sleep(0.05)
            finally:
                sub.close()

        return Response.streaming(
            gen(), "audio/x-raw", headers={"X-Audio-Rate": "8000"}
        )

    def _voice_pcm_response(recorders: list) -> Response:
        """HTTP chunked 8 kHz PCM16 from call recorders (reference
        ``trunking/api.py`` GET /stream/{sid}/voice/{streamId}.pcm)."""
        subs = [r_.audio.subscribe(maxsize=16) for r_ in recorders]

        async def gen():
            try:
                while True:
                    sent = False
                    for sub in subs:
                        pcm = sub.get_nowait()
                        if pcm is not None:
                            yield pack_pcm16(pcm).tobytes()
                            sent = True
                    if not sent:
                        yield b""  # liveness probe tick
                        await asyncio.sleep(0.05)
            finally:
                for sub in subs:
                    sub.close()

        return Response.streaming(
            gen(), "audio/x-raw", headers={"X-Audio-Rate": "8000"}
        )

    @r.get(v1 + "/stream/trunking/{sid}/voice\\.pcm")
    async def http_voice_all(req: Request) -> Response:
        sid = req.params["sid"]
        if sid not in state.trunking.systems:
            if sid in _worker_system_ids():
                hub = state.worker_streams
                return _worker_voice_response(
                    hub._get(hub.voice_all, sid).subscribe(maxsize=16)
                )
            raise HttpError(404)
        sys_ = state.trunking.get(sid)
        if sys_.pool is None:
            raise HttpError(409, "system not running")
        return _voice_pcm_response(list(sys_.pool.recorders))

    @r.get(v1 + "/stream/trunking/{sid}/voice/{rid}\\.pcm")
    async def http_voice_one(req: Request) -> Response:
        sid = req.params["sid"]
        try:
            rid = int(req.params["rid"])
        except ValueError:
            raise HttpError(404)
        if sid not in state.trunking.systems:
            if sid in _worker_system_ids():
                hub = state.worker_streams
                return _worker_voice_response(
                    hub._get(hub.voice_one, (sid, rid)).subscribe(maxsize=16)
                )
            raise HttpError(404)
        sys_ = state.trunking.get(sid)
        if sys_.pool is not None:
            for r_ in sys_.pool.recorders:
                if r_.id == rid:
                    return _voice_pcm_response([r_])
        raise HttpError(404)

    @r.get(v1 + "/trunking/systems/{sid}/spectrum")
    async def tk_spectrum(req: Request) -> Response:
        """Spectrum snapshot of the system's capture — works for both
        in-process and worker-hosted systems (workers forward FPS-capped
        frames over the event pipe, reference process_manager.py:262+)."""
        sid = req.params["sid"]
        if sid in state.trunking.systems:
            sys_ = state.trunking.get(sid)
            cap = getattr(sys_, "capture", None)
            if cap is None:
                raise HttpError(409, "system not running")
            sub = cap.spectrum_subs.subscribe(maxsize=2)
            try:
                spec = await asyncio.to_thread(sub.get, 10.0)
            except Exception:
                raise HttpError(409, "no spectrum available yet")
            finally:
                sub.close()
            frame = spec[-1] if spec.ndim == 2 else spec
            return Response.json(
                {
                    "centerHz": cap.config.center_hz,
                    "sampleRate": cap.config.sample_rate,
                    "db": [round(float(x), 1) for x in frame],
                }
            )
        msg = state.worker_streams.latest_spectrum.get(sid)
        if msg is None:
            if sid in _worker_system_ids():
                raise HttpError(409, "no spectrum forwarded yet")
            raise HttpError(404)
        return Response.json(
            {
                "centerHz": msg.get("centerHz"),
                "sampleRate": msg.get("sampleRate"),
                "db": [round(float(x), 1) for x in np.asarray(msg["db"])],
            }
        )

    @r.websocket(v1 + "/trunking/stream/{sid}/voice")
    async def ws_voice(req: Request, ws: WebSocket) -> None:
        sid = req.params["sid"]
        if sid not in state.trunking.systems:
            if sid in _worker_system_ids():
                hub = state.worker_streams
                await _pump_worker_voice(
                    ws, hub._get(hub.voice_all, sid).subscribe(maxsize=16)
                )
                return
            raise HttpError(404)
        sys_ = state.trunking.get(sid)
        if sys_.pool is None:
            await ws.close()
            return
        await _pump_voice(
            ws, [r_.audio.subscribe(maxsize=16) for r_ in sys_.pool.recorders]
        )

    @r.websocket(v1 + "/trunking/stream/{sid}/voice/{rid}")
    async def ws_voice_one(req: Request, ws: WebSocket) -> None:
        """One recorder's PCM only (reference WS .../voice/{stream_id})."""
        sid = req.params["sid"]
        try:
            rid = int(req.params["rid"])
        except ValueError:
            raise HttpError(404)
        if sid not in state.trunking.systems:
            if sid in _worker_system_ids():
                hub = state.worker_streams
                await _pump_worker_voice(
                    ws, hub._get(hub.voice_one, (sid, rid)).subscribe(maxsize=16)
                )
                return
            raise HttpError(404)
        sys_ = state.trunking.get(sid)
        rec = None
        if sys_.pool is not None:
            for r_ in sys_.pool.recorders:
                if r_.id == rid:
                    rec = r_
        if rec is None:
            raise HttpError(404)
        await _pump_voice(ws, [rec.audio.subscribe(maxsize=16)])

    # ---- scanners ----
    @r.get(v1 + "/scanners")
    async def scanners_list(req: Request) -> Response:
        return Response.json([s_.status() for s_ in state.scanners.values()])

    @r.post(v1 + "/scanners")
    async def scanner_create(req: Request) -> Response:
        from wavecap_tpu_torch.capture.scanner import (
            ScanEntry,
            ScanMode,
            ScannerConfig,
            ScannerService,
        )

        body = req.json()
        cap = state.get_capture(body.get("captureId", ""))
        chid = body.get("channelId", "")
        if chid not in cap.channels:
            raise HttpError(404, f"channel {chid} not in capture")
        try:
            entries = [
                ScanEntry(
                    frequency_hz=float(e["frequencyHz"]),
                    name=e.get("name", ""),
                    priority=int(e.get("priority", 5)),
                )
                for e in body.get("entries", [])
            ]
            cfg = ScannerConfig(
                entries=entries,
                mode=ScanMode(body.get("mode", "sequential")),
                dwell_s=float(body.get("dwellS", 0.5)),
                hold_s=float(body.get("holdS", 2.0)),
                squelch_db=float(body.get("squelchDb", -60.0)),
            )
        except (KeyError, ValueError) as e:
            raise HttpError(422, str(e))
        svc = ScannerService(cap, chid, cfg)
        state.scanners[svc.id] = svc
        if body.get("autoStart", True):
            svc.start()
        return Response.json(svc.status(), status=201)

    @r.get(v1 + "/scanners/{sid}")
    async def scanner_get(req: Request) -> Response:
        svc = state.scanners.get(req.params["sid"])
        if svc is None:
            raise HttpError(404)
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/start")
    async def scanner_start(req: Request) -> Response:
        svc = state.scanners.get(req.params["sid"])
        if svc is None:
            raise HttpError(404)
        svc.start()
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/stop")
    async def scanner_stop(req: Request) -> Response:
        svc = state.scanners.get(req.params["sid"])
        if svc is None:
            raise HttpError(404)
        await asyncio.to_thread(svc.stop)
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/lockout")
    async def scanner_lockout(req: Request) -> Response:
        svc = state.scanners.get(req.params["sid"])
        if svc is None:
            raise HttpError(404)
        body = req.json()
        svc.lockout(float(body["frequencyHz"]), bool(body.get("locked", True)))
        return Response.json(svc.status())

    def _get_scanner(req: Request):
        svc = state.scanners.get(req.params["sid"])
        if svc is None:
            raise HttpError(404)
        return svc

    @r.post(v1 + "/scanners/{sid}/pause")
    async def scanner_pause(req: Request) -> Response:
        svc = _get_scanner(req)
        svc.pause()
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/resume")
    async def scanner_resume(req: Request) -> Response:
        svc = _get_scanner(req)
        svc.resume()
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/lock")
    async def scanner_lock(req: Request) -> Response:
        svc = _get_scanner(req)
        svc.lock()
        return Response.json(svc.status())

    @r.post(v1 + "/scanners/{sid}/unlock")
    async def scanner_unlock(req: Request) -> Response:
        svc = _get_scanner(req)
        svc.unlock()
        return Response.json(svc.status())

    @r.patch(v1 + "/scanners/{sid}")
    async def scanner_patch(req: Request) -> Response:
        """Update dwell/hold/squelch/mode live (reference PATCH
        /scanners/{sid})."""
        from wavecap_tpu_torch.capture.scanner import ScanMode

        svc = _get_scanner(req)
        body = req.json() or {}
        try:
            if "mode" in body:
                svc.config.mode = ScanMode(body["mode"])
            if "dwellS" in body:
                svc.config.dwell_s = float(body["dwellS"])
            if "holdS" in body:
                svc.config.hold_s = float(body["holdS"])
            if "squelchDb" in body:
                svc.config.squelch_db = float(body["squelchDb"])
        except ValueError as e:
            raise HttpError(422, str(e))
        return Response.json(svc.status())

    @r.delete(v1 + "/scanners/{sid}/lockout/{freq}")
    async def scanner_lockout_delete(req: Request) -> Response:
        svc = _get_scanner(req)
        try:
            svc.lockout(float(req.params["freq"]), False)
        except ValueError:
            raise HttpError(422, "freq must be Hz")
        return Response.json(svc.status())

    @r.delete(v1 + "/scanners/{sid}/lockouts")
    async def scanner_lockouts_clear(req: Request) -> Response:
        svc = _get_scanner(req)
        svc.clear_lockouts()
        return Response.json(svc.status())

    @r.delete(v1 + "/scanners/{sid}")
    async def scanner_delete(req: Request) -> Response:
        svc = state.scanners.pop(req.params["sid"], None)
        if svc:
            await asyncio.to_thread(svc.stop)
        return Response.json({"ok": True})

    # ---- channel attachments (POCSAG / FLEX / RDS decoders) ----
    @r.post(v1 + "/channels/{chid}/attachments")
    async def attachment_create(req: Request) -> Response:
        from wavecap_tpu_torch.capture.attachments import ATTACHMENT_KINDS

        cap, ch = state.find_channel(req.params["chid"])
        kind = req.json().get("kind", "")
        cls = ATTACHMENT_KINDS.get(kind)
        if cls is None:
            raise HttpError(422, f"unknown attachment kind {kind!r}")
        key = (ch.id, kind)
        if key in state.attachments:
            raise HttpError(409, "attachment exists")
        if kind == "rds":
            # RDS consumes the wide slot's pre-MPX baseband; enabling the
            # export rebuilds the capture pipeline once
            att = cls(ch, capture=cap)
        else:
            if kind in ("pocsag", "flex") and ch.spec.mode.lower() == "nbfm":
                # pager FSK rides the FM discriminator: the nbfm voice
                # band shaping (300 Hz highpass forced on in bank_cfg)
                # destroys the low-frequency bit runs — round-3 find via
                # the RF-path audit; decoding worked only on synthetic
                # audio fed straight to the decoder.  Disabling the voice
                # filters re-keys the channel's bank (one rebuild).
                dsp = dict(ch.spec.dsp)
                dsp.update(
                    enable_highpass=False,
                    enable_lowpass=False,
                    enable_deemphasis=False,
                )
                cap.update_channel(ch.id, dsp=dsp)
            att = cls(ch, audio_rate=state.config.stream.audio_rate)
        state.attachments[key] = att
        return Response.json(att.status(), status=201)

    @r.get(v1 + "/channels/{chid}/attachments")
    async def attachments_list(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        return Response.json(
            [a.status() for (cid, _), a in state.attachments.items() if cid == ch.id]
        )

    @r.get(v1 + "/channels/{chid}/messages")
    async def channel_messages(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        out = []
        aliases = state.config.pocsag_aliases
        for (cid, kind), a in state.attachments.items():
            if cid == ch.id:
                for m in list(a.messages):
                    entry = {"decoder": kind, **m}
                    if kind == "pocsag" and m.get("address") in aliases:
                        entry["alias"] = aliases[m["address"]]
                    out.append(entry)
        out.sort(key=lambda m: m.get("time", 0))
        return Response.json(out[-int(req.query.get("limit", "100")):])

    @r.delete(v1 + "/channels/{chid}/attachments/{kind}")
    async def attachment_delete(req: Request) -> Response:
        cap, ch = state.find_channel(req.params["chid"])
        att = state.attachments.pop((ch.id, req.params["kind"]), None)
        if att:
            await asyncio.to_thread(att.stop)
        return Response.json({"ok": True})

    # ---- MCP ----
    from .mcp import mount_mcp

    mount_mcp(r, state, api_key=state.config.server.api_key)

    @r.get(v1 + "/stream/formats")
    async def formats(req: Request) -> Response:
        from .encoders import available_formats

        return Response.json({"formats": available_formats()})

    # ---- HTTP chunked audio (VLC-style players; reference api.py:2483-2650
    # serves .mp3/.opus/.aac/.pcm via StreamingResponse) ----

    def _audio_stream_response(chid: str, fmt: str) -> Response:
        import queue as _queue

        from .encoders import available_formats, make_encoder

        cap, ch = state.find_channel(chid)
        if fmt not in available_formats():
            raise HttpError(404, f"format {fmt} unavailable (ffmpeg missing?)")
        media = {
            "mp3": "audio/mpeg",
            "opus": "audio/opus",
            "aac": "audio/aac",
            "pcm16": "audio/x-raw",
            "f32": "audio/x-raw",
        }[fmt]
        rate = state.config.stream.audio_rate
        encoder = make_encoder(fmt, rate)
        sub = ch.audio.subscribe(maxsize=16)

        async def gen():
            try:
                while True:
                    try:
                        audio = await asyncio.to_thread(sub.get, 2.0)
                    except _queue.Empty:
                        yield b""  # liveness probe tick
                        continue
                    except RuntimeError:
                        return  # event loop shutting down mid-stream
                    data = encoder.encode(audio)
                    if data:
                        yield data
            finally:
                sub.close()
                encoder.close()

        return Response.streaming(
            gen(), media, headers={"X-Audio-Rate": str(rate)}
        )

    for _ext in ("mp3", "opus", "aac", "pcm"):

        def _mk(ext: str):
            async def http_audio(req: Request) -> Response:
                fmt = "pcm16" if ext == "pcm" else ext
                return _audio_stream_response(req.params["chid"], fmt)

            return http_audio

        r.get(v1 + "/stream/channels/{chid}\\." + _ext)(_mk(_ext))

    # ---- static frontend ----
    static_dir = Path(__file__).parent / "static"

    @r.get("/")
    async def index(req: Request) -> Response:
        f = static_dir / "index.html"
        if not f.exists():
            raise HttpError(404)
        return Response(body=f.read_bytes(), content_type="text/html")

    @r.get("/static/{name+}")
    async def static_file(req: Request) -> Response:
        name = req.params["name"]
        f = (static_dir / name).resolve()
        if (
            not str(f).startswith(str(static_dir.resolve()) + "/")
            or not f.is_file()
        ):
            raise HttpError(404)
        ctype = {
            ".html": "text/html", ".js": "text/javascript", ".css": "text/css",
            ".svg": "image/svg+xml", ".png": "image/png", ".ico": "image/x-icon",
            ".json": "application/json", ".map": "application/json",
            ".woff2": "font/woff2",
        }.get(f.suffix, "application/octet-stream")
        return Response(body=f.read_bytes(), content_type=ctype)

    # ---- health root ----
    @r.get(v1 + "/health")
    async def health(req: Request) -> Response:
        return Response.json({"status": "ok", "uptimeS": time.time() - state.started_at})

    return r


async def _sub_get(sub, ws, timeout: float = 5.0):
    """Blocking-queue get that keeps the WS alive through slow warmup."""
    import queue as _queue

    while not ws.closed:
        try:
            return await asyncio.to_thread(sub.get, timeout)
        except _queue.Empty:
            continue
    raise ConnectionError("websocket closed")


def _safe_put(q: asyncio.Queue, item) -> None:
    try:
        q.put_nowait(item)
    except asyncio.QueueFull:
        pass


class AppServer:
    """Server + state lifecycle (create_app + lifespan equivalent)."""

    def __init__(self, cfg: config_mod.AppConfig | None = None, device=None):
        self.config = cfg or config_mod.AppConfig()
        self.state = AppState(self.config, device=device)
        self.router = build_router(self.state)
        self.http = HttpServer(
            self.router, self.config.server.host, self.config.server.port
        )
        if self.config.server.api_key:
            async def auth(req: Request):
                if req.path.startswith("/api/") and req.headers.get(
                    "x-api-key"
                ) != self.config.server.api_key:
                    raise HttpError(401)

            self.http.middleware.append(auth)
        limit = self.config.server.rate_limit_per_min
        if limit > 0:
            # per-IP sliding-minute limiter (reference slowapi 200/min,
            # reference app.py:366); applies to WS upgrades too (httpd runs
            # middleware before completing the handshake)
            buckets: dict[str, list] = {}

            async def rate_limit(req: Request):
                now = time.time()
                q = buckets.setdefault(req.remote, [])
                while q and now - q[0] > 60.0:
                    q.pop(0)
                if len(q) >= limit:
                    raise HttpError(429, "rate limit exceeded")
                q.append(now)
                if len(buckets) > 10_000:  # bound memory under IP churn
                    buckets.clear()

            self.http.middleware.append(rate_limit)

    async def start(self) -> None:
        self.state.apply_config()
        await self.http.start()
        logger.info("wavecap_tpu serving on port %d", self.http.bound_port)

    async def stop(self) -> None:
        await self.http.stop()
        self.state.shutdown()

    @property
    def port(self) -> int:
        return self.http.bound_port
