"""Configuration system: dataclass-typed YAML with local overlay.

Reference parity: ``config.py:170-187`` (``AppConfig`` sections), base
``wavecap.yaml`` + gitignored ``wavecap.local.yaml`` overlay merged in
order (reference ``config.py:15-16,199``), env-var log levels, presets
and recipes.

The port's copy of ``wavecap_tpu/utils/config.py``, with the same public names.
"""

from __future__ import annotations

import logging
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

CONFIG_BASENAME = "wavecap.yaml"
CONFIG_LOCAL_BASENAME = "wavecap.local.yaml"


@dataclass
class ServerConfig:
    rate_limit_per_min: int = 200  # 0 disables (reference slowapi 200/min)
    host: str = "0.0.0.0"
    port: int = 8087
    api_key: str | None = None


@dataclass
class StreamConfig:
    audio_rate: int = 48_000
    fft_size: int = 2048
    spectrum_fps: float = 10.0
    iq_format: str = "iq16"  # iq16 | f32
    # default multi-chip backend for new captures: a mesh spec like
    # "stream=1,time=8" shards each capture's block step over
    # torchenv.devices() (capture/mesh.py); None = single-card
    mesh: str | None = None
    # listener-gated audio fetch (CaptureConfig.audio_fetch_slots): > 0
    # fetches only this many narrow-bank audio rows per bank, selected by
    # which channels have live subscribers — the device->host audio bytes
    # dominate at high channel counts.  0 = fetch every slot's audio.
    audio_fetch_slots: int = 0
    # default host->device IQ transport for new captures
    # (engine.CaptureConfig.transport): i4 | i8 | i16 | f32
    transport: str = "i16"
    # auto-degrade the transport down the i16->i8->i4 ladder when the
    # measured per-batch budget approaches realtime, recover when the
    # link clears (engine.CaptureConfig.adaptive_transport); the
    # configured transport is the fidelity ceiling
    adaptive_transport: bool = True


@dataclass
class LimitsConfig:
    max_captures: int = 4
    max_channels_per_capture: int = 8
    max_wide_channels: int = 2
    max_p25_channels: int = 4
    # P25 Phase 2 TDMA (6000-baud H-DQPSK) voice slots per capture
    max_p25p2_channels: int = 2


@dataclass
class DeviceSection:
    driver: str = "fake"  # fake | file | rtl | soapy | native | auto
    file_path: str | None = None
    device_args: dict = field(default_factory=dict)
    # with driver=auto (composite): keep fake devices visible even when
    # real hardware enumerates (reference show_fake_device)
    show_fake_device: bool = False


@dataclass
class TrunkingWorkersConfig:
    mode: str = "in_process"  # in_process | per_device


@dataclass
class RecoveryConfig:
    watchdog_timeout_s: float = 30.0
    startup_timeout_s: float = 45.0
    max_restarts_per_hour: int = 6
    restart_cooldown_s: float = 60.0


@dataclass
class ChannelSpecConfig:
    id: str
    mode: str
    frequency_hz: float
    squelch_db: float | None = None
    name: str = ""
    dsp: dict = field(default_factory=dict)  # demod config overrides


@dataclass
class CaptureSpecConfig:
    id: str
    center_hz: float
    sample_rate: int = 2_400_000
    device_id: str | None = None
    gain_db: float | None = None
    auto_start: bool = True
    mesh: str | None = None  # per-capture multi-chip backend override
    channels: list = field(default_factory=list)


@dataclass
class AppConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    limits: LimitsConfig = field(default_factory=LimitsConfig)
    device: DeviceSection = field(default_factory=DeviceSection)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    trunking_workers: TrunkingWorkersConfig = field(
        default_factory=TrunkingWorkersConfig
    )
    captures: list = field(default_factory=list)
    trunking_systems: list = field(default_factory=list)  # raw dicts
    presets: dict = field(default_factory=dict)
    recipes: dict = field(default_factory=dict)
    pocsag_aliases: dict = field(default_factory=dict)  # capcode -> name
    config_paths: list = field(default_factory=list)


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _config_chain(path: str | Path | None) -> list[Path]:
    if path is not None:
        p = Path(path)
        local = p.with_name(p.stem + ".local" + p.suffix)
        return [p] + ([local] if local.exists() else [])
    cwd = Path.cwd()
    chain = []
    for name in (CONFIG_BASENAME, CONFIG_LOCAL_BASENAME):
        cand = cwd / name
        if cand.exists():
            chain.append(cand)
    return chain


def load_config(path: str | Path | None = None) -> AppConfig:
    """Load base + ``.local`` overlay (overlay wins key-by-key)."""
    merged: dict[str, Any] = {}
    paths = _config_chain(path)
    if paths:
        import yaml  # only to parse a file: the package runs without PyYAML
    for p in paths:
        try:
            with open(p) as f:
                d = yaml.safe_load(f) or {}
            merged = _deep_merge(merged, d)
        except OSError as e:
            logger.warning("cannot read config %s: %s", p, e)
    return config_from_dict(merged, [str(p) for p in paths])


def config_from_dict(d: dict, paths: list[str] | None = None) -> AppConfig:
    def sect(cls, key, **renames):
        raw = dict(d.get(key) or {})
        known = {f_.name for f_ in cls.__dataclass_fields__.values()}
        return cls(**{k: v for k, v in raw.items() if k in known})

    captures = []
    for c in d.get("captures") or []:
        chans = [
            ChannelSpecConfig(
                id=str(ch["id"]),
                mode=str(ch.get("mode", "nbfm")),
                frequency_hz=float(ch.get("frequency_hz", ch.get("frequencyHz", 0))),
                squelch_db=ch.get("squelch_db", ch.get("squelchDb")),
                name=ch.get("name", ""),
                dsp={
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in (ch.get("dsp") or {}).items()
                },
            )
            for ch in (c.get("channels") or [])
        ]
        captures.append(
            CaptureSpecConfig(
                id=str(c["id"]),
                center_hz=float(c.get("center_hz", c.get("centerHz", 100e6))),
                # int(float(...)) because YAML 1.1 parses "2.4e6" (no sign after
                # the exponent marker) as a *string*, not a float.
                sample_rate=int(float(c.get("sample_rate", c.get("sampleRate", 2_400_000)))),
                device_id=c.get("device_id", c.get("deviceId")),
                gain_db=c.get("gain_db", c.get("gainDb")),
                auto_start=bool(c.get("auto_start", c.get("autoStart", True))),
                mesh=c.get("mesh"),
                channels=chans,
            )
        )

    return AppConfig(
        server=sect(ServerConfig, "server"),
        trunking_workers=sect(TrunkingWorkersConfig, "trunking_workers"),
        stream=sect(StreamConfig, "stream"),
        limits=sect(LimitsConfig, "limits"),
        device=sect(DeviceSection, "device"),
        recovery=sect(RecoveryConfig, "recovery"),
        captures=captures,
        trunking_systems=list(d.get("trunking_systems") or d.get("trunkingSystems") or []),
        presets=dict(d.get("presets") or {}),
        recipes=dict(d.get("recipes") or {}),
        pocsag_aliases={
            int(k): str(v)
            for k, v in (d.get("pocsag_aliases") or {}).items()
            if str(k).lstrip("-").isdigit()
        },
        config_paths=paths or [],
    )


def log_level_from_env(default: str = "INFO") -> int:
    name = os.environ.get("WAVECAP_LOG_LEVEL", default).upper()
    return getattr(logging, name, logging.INFO)
