"""LRRP (Location Request/Response Protocol) GPS decoding.

Behavioral port of reference ``decoders/lrrp.py`` (radio GPS from LRRP
packets and P25 extended link control): TLV-ish LRRP parsing for the
common unsolicited location report, plus a TTL'd per-radio location cache.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class RadioLocation:
    radio_id: int
    latitude: float
    longitude: float
    altitude_m: float | None = None
    speed_kmh: float | None = None
    heading_deg: float | None = None
    time: float = field(default_factory=time.time)


def _u(b: bytes, i: int, n: int) -> int:
    return int.from_bytes(b[i : i + n], "big")


def _s(b: bytes, i: int, n: int) -> int:
    return int.from_bytes(b[i : i + n], "big", signed=True)


def parse_lrrp(payload: bytes, radio_id: int = 0) -> RadioLocation | None:
    """Parse an LRRP message (DMR/P25 data burst payload).

    Handles the common ``Immediate Location Report`` shape: message type
    byte, length, then token stream with 0x66/0x51 (lat/lon point),
    0x6C (lat/lon/alt), 0x56 (speed), 0x5x heading tokens.
    """
    if len(payload) < 6:
        return None
    # message type: 0x07/0x0D/0x11 variants carry reports
    if payload[0] not in (0x05, 0x07, 0x0D, 0x11, 0x13, 0x1D):
        return None
    i = 2  # skip type + length
    lat = lon = None
    alt = speed = heading = None
    while i < len(payload) - 1:
        token = payload[i]
        if token in (0x51, 0x66) and i + 9 <= len(payload):
            lat = _s(payload, i + 1, 4) * (180.0 / 2**32)
            lon = _s(payload, i + 5, 4) * (360.0 / 2**32)
            i += 9
        elif token == 0x6C and i + 11 <= len(payload):
            lat = _s(payload, i + 1, 4) * (180.0 / 2**32)
            lon = _s(payload, i + 5, 4) * (360.0 / 2**32)
            alt = float(_u(payload, i + 9, 2))
            i += 11
        elif token == 0x56 and i + 2 <= len(payload):
            speed = payload[i + 1] * 1.0
            i += 2
        elif token == 0x6A and i + 2 <= len(payload):
            heading = payload[i + 1] * 2.0
            i += 2
        else:
            i += 1
    if lat is None or lon is None:
        return None
    if not (-90 <= lat <= 90 and -180 <= lon <= 180):
        return None
    return RadioLocation(
        radio_id=radio_id,
        latitude=lat,
        longitude=lon,
        altitude_m=alt,
        speed_kmh=speed,
        heading_deg=heading,
    )


def encode_location_report(
    lat: float, lon: float, altitude_m: float | None = None
) -> bytes:
    """Synthesize an LRRP report (tests)."""
    out = bytearray([0x0D, 0x00])
    lat_i = int(lat / (180.0 / 2**32))
    lon_i = int(lon / (360.0 / 2**32))
    if altitude_m is not None:
        out.append(0x6C)
        out += lat_i.to_bytes(4, "big", signed=True)
        out += lon_i.to_bytes(4, "big", signed=True)
        out += int(altitude_m).to_bytes(2, "big")
    else:
        out.append(0x66)
        out += lat_i.to_bytes(4, "big", signed=True)
        out += lon_i.to_bytes(4, "big", signed=True)
    out[1] = len(out) - 2
    return bytes(out)


class LocationCache:
    """Per-radio location cache with TTL (reference lrrp.py:352)."""

    def __init__(self, ttl_s: float = 300.0):
        self.ttl_s = ttl_s
        self._entries: dict[int, RadioLocation] = {}

    def update(self, loc: RadioLocation) -> None:
        self._entries[loc.radio_id] = loc

    def get(self, radio_id: int) -> RadioLocation | None:
        loc = self._entries.get(radio_id)
        if loc and time.time() - loc.time <= self.ttl_s:
            return loc
        return None

    def all(self) -> list[RadioLocation]:
        now = time.time()
        return [l for l in self._entries.values() if now - l.time <= self.ttl_s]
