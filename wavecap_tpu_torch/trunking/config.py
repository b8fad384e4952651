"""Trunking system configuration (reference ``trunking/config.py`` parity).

YAML/dict-driven system config + talkgroup lists (CSV importable in the
RadioReference export format the reference consumes,
reference ``trunking/config.py:load_talkgroups_csv``).

The port's copy of ``wavecap_tpu/trunking/config.py``, with the same public names.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any


class TrunkingProtocol(str, Enum):
    P25_PHASE1 = "p25_phase1"
    P25_PHASE2 = "p25_phase2"
    DMR_TIER3 = "dmr_tier3"


class HuntMode(str, Enum):
    FIXED = "fixed"  # stay on configured control channel
    HUNT = "hunt"  # cycle through list on loss
    SCAN = "scan"  # measure all, pick best


@dataclass
class TalkgroupConfig:
    tgid: int
    name: str = ""
    category: str = ""
    priority: int = 5  # 1 = highest
    record: bool = True
    monitor: bool = True


@dataclass
class TrunkingSystemConfig:
    id: str
    name: str = ""
    protocol: TrunkingProtocol = TrunkingProtocol.P25_PHASE1
    control_channels: list[float] = field(default_factory=list)  # Hz
    center_hz: float | None = None  # capture center; default = mean of CCs
    sample_rate: int = 2_400_000
    device_id: str | None = None
    hunt_mode: HuntMode = HuntMode.HUNT
    hunt_timeout_s: float = 10.0
    # sync-verified scanning / roaming (reference cc_scanner.py defaults:
    # +6 dB roam margin, 30 s re-check while locked)
    probe_window_s: float = 1.5
    roam_interval_s: float = 30.0
    roam_margin_db: float = 6.0
    max_voice_channels: int = 4
    min_call_duration_s: float = 1.0
    call_hold_s: float = 2.0
    record_audio: bool = True
    recording_dir: str = "recordings"
    talkgroups: dict[int, TalkgroupConfig] = field(default_factory=dict)
    monitor_unknown_talkgroups: bool = True
    # DMR Tier III channel plan: logical channel n (1-based) maps to
    # carrier (n-1)//slots at base + carrier*spacing, timeslot (n-1)%slots
    # (P25 gets this mapping over the air via IDEN_UP; DMR needs it
    # configured).  base defaults to the first control channel.
    dmr_base_hz: float | None = None
    dmr_spacing_hz: float = 12_500.0
    dmr_slots_per_carrier: int = 2
    # CQPSK/LSM simulcast equalizer taps for this system's capture
    # (0 = off; odd, e.g. 127).  None (round 5) = AUTO: LSM (cqpsk
    # Phase 1) systems — which exist FOR simulcast networks — compile the
    # echo fit in with 41 taps; it holds identity until the fit is
    # decisive for consecutive blocks AND the slot is near bin center
    # (models/p25/equalizer.py runtime guard), so clean channels pay only
    # the fit, never a spurious inverse.  Other protocols default to 0.
    equalizer_taps: int | None = None
    # Host->device IQ transport for this system's capture: "i8" (default,
    # the 8-bit front-end dynamic-range model) or "i4" to halve the
    # upload again on upload-bound relays (quantization noise is white
    # across the capture band — see engine.CaptureConfig.transport)
    transport: str = "i8"
    # Phase 1 air-interface override: "cqpsk" selects the LSM simulcast
    # demod for control + voice (reference P25Modulation C4FM/LSM,
    # reference decoders/p25.py:1755); None = protocol default (Phase 1
    # C4FM, Phase 2 CQPSK).
    modulation: str | None = None
    # Multi-chip backend: a mesh spec like "stream=1,time=8" runs this
    # system's capture through the sharded grid (capture/mesh.py) — every
    # channelizer bin demodulated as soft symbols, CC + voice slots mapped
    # to bins.  Phase 2 rides the dual-rate grid (each bin shifted once,
    # demodulated at both 4800 and 6000 baud — round 4).
    # None = single-chip slot-bank program.
    mesh: str | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrunkingSystemConfig":
        tgs = {}
        for tg in d.get("talkgroups", []) or []:
            if isinstance(tg, dict):
                t = TalkgroupConfig(
                    tgid=int(tg["tgid"]),
                    name=tg.get("name", ""),
                    category=tg.get("category", ""),
                    priority=int(tg.get("priority", 5)),
                    record=bool(tg.get("record", True)),
                    monitor=bool(tg.get("monitor", True)),
                )
                tgs[t.tgid] = t
        cc = [float(f) for f in d.get("control_channels", d.get("controlChannels", []))]
        return cls(
            id=str(d["id"]),
            name=d.get("name", str(d["id"])),
            protocol=TrunkingProtocol(
                {"p25": "p25_phase1", "p25p2": "p25_phase2"}.get(
                    str(d.get("protocol", "p25_phase1")).lower(),
                    str(d.get("protocol", "p25_phase1")).lower(),
                )
            ),
            control_channels=cc,
            center_hz=d.get("center_hz", d.get("centerHz")),
            # int(float(...)): YAML 1.1 treats "2.4e6" as a string (see utils/config.py)
            sample_rate=int(float(d.get("sample_rate", d.get("sampleRate", 2_400_000)))),
            device_id=d.get("device_id", d.get("deviceId")),
            hunt_mode=HuntMode(d.get("hunt_mode", d.get("huntMode", "hunt"))),
            hunt_timeout_s=float(d.get("hunt_timeout_s", d.get("huntTimeoutS", 10.0))),
            probe_window_s=float(d.get("probe_window_s", d.get("probeWindowS", 1.5))),
            roam_interval_s=float(d.get("roam_interval_s", d.get("roamIntervalS", 30.0))),
            roam_margin_db=float(d.get("roam_margin_db", d.get("roamMarginDb", 6.0))),
            max_voice_channels=int(d.get("max_voice_channels", d.get("maxVoiceChannels", 4))),
            min_call_duration_s=float(d.get("min_call_duration_s", 1.0)),
            call_hold_s=float(d.get("call_hold_s", 2.0)),
            record_audio=bool(d.get("record_audio", d.get("recordAudio", True))),
            recording_dir=str(d.get("recording_dir", d.get("recordingDir", "recordings"))),
            talkgroups=tgs,
            monitor_unknown_talkgroups=bool(d.get("monitor_unknown_talkgroups", True)),
            dmr_base_hz=d.get("dmr_base_hz", d.get("dmrBaseHz")),
            dmr_spacing_hz=float(d.get("dmr_spacing_hz", d.get("dmrSpacingHz", 12_500.0))),
            dmr_slots_per_carrier=int(
                d.get("dmr_slots_per_carrier", d.get("dmrSlotsPerCarrier", 2))
            ),
            modulation=d.get("modulation"),
            equalizer_taps=(
                int(v)
                if (v := d.get("equalizer_taps", d.get("equalizerTaps")))
                is not None
                else None
            ),
            transport=str(d.get("transport", "i8")),
            mesh=d.get("mesh"),
        )

    @property
    def effective_equalizer_taps(self) -> int:
        """Resolved equalizer taps: explicit value, or the auto policy —
        41 taps (guarded, hysteresis-gated) for Phase 1 LSM (cqpsk)
        systems, 0 elsewhere."""
        if self.equalizer_taps is not None:
            return int(self.equalizer_taps)
        if self.mesh:
            # the mesh grid demodulates EVERY bin — auto-compiling the
            # echo fit there multiplies its cost by the bin count for
            # bins that are bin-centered by construction; opt in
            # explicitly if a simulcast mesh system needs it
            return 0
        phase1_lsm = (
            self.protocol == TrunkingProtocol.P25_PHASE1
            and (self.modulation or "").lower() == "cqpsk"
        )
        return 41 if phase1_lsm else 0

    def effective_center_hz(self) -> float:
        if self.center_hz is not None:
            return float(self.center_hz)
        if not self.control_channels:
            raise ValueError("no control channels configured")
        return float(np_mean(self.control_channels))

    def talkgroup(self, tgid: int) -> TalkgroupConfig:
        tg = self.talkgroups.get(tgid)
        if tg is None:
            tg = TalkgroupConfig(
                tgid=tgid,
                name=f"TG {tgid}",
                record=self.monitor_unknown_talkgroups,
                monitor=self.monitor_unknown_talkgroups,
            )
        return tg


def np_mean(vals: list[float]) -> float:
    return sum(vals) / len(vals)


def load_talkgroups_csv(path: str | Path) -> dict[int, TalkgroupConfig]:
    """RadioReference-style CSV file: Decimal, Alpha Tag/Description, Category…"""
    with open(path, newline="") as f:
        return parse_talkgroups_csv(f)


def parse_talkgroups_csv(f) -> dict[int, TalkgroupConfig]:
    """Parse RadioReference-style talkgroup CSV from any line iterable
    (file object or ``text.splitlines()``)."""
    out: dict[int, TalkgroupConfig] = {}
    reader = csv.DictReader(f)
    for row in reader:
        low = {k.lower().strip(): (v or "").strip() for k, v in row.items() if k}
        tgid_s = low.get("decimal") or low.get("tgid") or low.get("dec")
        if not tgid_s:
            continue
        try:
            tgid = int(tgid_s)
        except ValueError:
            continue
        name = (
            low.get("alpha tag")
            or low.get("alphatag")
            or low.get("description")
            or low.get("name")
            or f"TG {tgid}"
        )
        out[tgid] = TalkgroupConfig(
            tgid=tgid,
            name=name,
            category=low.get("category", low.get("tag", "")),
            priority=int(low.get("priority") or 5),
        )
    return out
