"""TSBK message parsing: typed dicts from decoded trunking signal blocks.

Field layouts per TIA-102.AABB (cross-checked with the reference's
SDRTrunk-derived parser, reference ``decoders/p25_tsbk.py:178``).  Bit
positions quoted in comments are absolute TSBK bit numbers (0 = LB), so
``data`` bytes start at bit 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Any


class TSBKOpcode(IntEnum):
    GRP_V_CH_GRANT = 0x00
    GRP_V_CH_GRANT_UPDT = 0x02
    GRP_V_CH_GRANT_UPDT_EXP = 0x03
    UU_V_CH_GRANT = 0x04
    UU_ANS_REQ = 0x05
    UU_V_CH_GRANT_UPDT = 0x06
    TEL_INT_CH_GRANT = 0x08
    TEL_INT_CH_GRANT_UPDT = 0x09
    SNDCP_CH_GNT = 0x14
    STATUS_UPDT = 0x18
    MSG_UPDT = 0x1C
    CALL_ALRT = 0x1F
    ACK_RSP = 0x20
    QUE_RSP = 0x21
    EXT_FNCT_CMD = 0x24
    DENY_RSP = 0x27
    GRP_AFF_RSP = 0x28
    SCCB_EXP = 0x29
    LOC_REG_RSP = 0x2B
    UNIT_REG_RSP = 0x2C
    UNIT_DEREG_ACK = 0x2F
    IDEN_UP_TDMA = 0x33
    IDEN_UP_VU = 0x34
    TIME_DATE_ANN = 0x35
    SYS_SRV_BCAST = 0x38
    SCCB = 0x39
    RFSS_STS_BCAST = 0x3A
    NET_STS_BCAST = 0x3B
    ADJ_STS_BCAST = 0x3C
    IDEN_UP = 0x3D


@dataclass
class ChannelIdentifier:
    """IDEN_UP channel-number -> frequency mapping (one per 4-bit band id).

    TDMA bands (IDEN_UP_TDMA) pack the timeslot into the channel number:
    carrier = channel // slots_per_carrier, slot = channel % slots
    (reference ``trunking/network_config.py`` FrequencyBand.is_tdma).
    """

    identifier: int
    bandwidth_khz: float
    tx_offset_mhz: float
    channel_spacing_khz: float
    base_freq_mhz: float
    slots_per_carrier: int = 1

    def frequency_hz(self, channel_number: int) -> float:
        carrier = channel_number // max(self.slots_per_carrier, 1)
        return (
            self.base_freq_mhz + carrier * self.channel_spacing_khz / 1000.0
        ) * 1e6

    def slot(self, channel_number: int) -> int:
        return channel_number % max(self.slots_per_carrier, 1)

    @property
    def is_tdma(self) -> bool:
        return self.slots_per_carrier > 1


def parse_tsbk(opcode: int, mfid: int, data: bytes) -> dict[str, Any]:
    """Parse one TSBK's 8 data bytes into a typed dict."""
    result: dict[str, Any] = {"opcode": opcode, "mfid": mfid}
    if mfid not in (0x00, 0x01):
        result["type"] = "VENDOR"
        result["data"] = data.hex()
        return result
    try:
        op = TSBKOpcode(opcode)
    except ValueError:
        result["type"] = "UNKNOWN"
        result["data"] = data.hex()
        return result

    if op in (TSBKOpcode.GRP_V_CH_GRANT, TSBKOpcode.GRP_V_CH_GRANT_UPDT):
        _parse_group_grant(data, result, op)
    elif op == TSBKOpcode.UU_V_CH_GRANT:
        _parse_uu_grant(data, result)
    elif op in (TSBKOpcode.IDEN_UP, TSBKOpcode.IDEN_UP_VU):
        _parse_iden_up_vu(data, result, op)
    elif op == TSBKOpcode.IDEN_UP_TDMA:
        _parse_iden_up_tdma(data, result)
    elif op == TSBKOpcode.RFSS_STS_BCAST:
        _parse_rfss_status(data, result)
    elif op == TSBKOpcode.NET_STS_BCAST:
        _parse_net_status(data, result)
    elif op == TSBKOpcode.ADJ_STS_BCAST:
        _parse_adjacent_status(data, result)
    elif op == TSBKOpcode.SYS_SRV_BCAST:
        result["type"] = "SYSTEM_SERVICE"
        result["services"] = int.from_bytes(data[1:4], "big")
    elif op == TSBKOpcode.GRP_AFF_RSP:
        result["type"] = "GROUP_AFFILIATION_RESPONSE"
        result["tgid"] = (data[3] << 8) | data[4]
        result["source_id"] = int.from_bytes(data[5:8], "big")
    elif op == TSBKOpcode.UNIT_REG_RSP:
        result["type"] = "UNIT_REGISTRATION_RESPONSE"
        result["source_id"] = int.from_bytes(data[5:8], "big")
    elif op == TSBKOpcode.DENY_RSP:
        result["type"] = "DENY_RESPONSE"
        result["reason"] = data[1]
        result["target"] = int.from_bytes(data[5:8], "big")
    elif op == TSBKOpcode.STATUS_UPDT:
        result["type"] = "STATUS_UPDATE"
        result["status"] = (data[0] << 8) | data[1]
        result["target"] = int.from_bytes(data[2:5], "big")
        result["source_id"] = int.from_bytes(data[5:8], "big")
    elif op == TSBKOpcode.CALL_ALRT:
        result["type"] = "CALL_ALERT"
        result["target"] = int.from_bytes(data[2:5], "big")
        result["source_id"] = int.from_bytes(data[5:8], "big")
    else:
        result["type"] = op.name
        result["data"] = data.hex()
    return result


def _service_options(svc: int, result: dict[str, Any]) -> None:
    result["emergency"] = bool(svc & 0x80)
    result["encrypted"] = bool(svc & 0x40)
    result["duplex"] = bool(svc & 0x20)
    result["slot_id"] = (svc >> 3) & 1
    result["priority"] = svc & 0x07


def _parse_group_grant(data: bytes, result: dict[str, Any], op: TSBKOpcode) -> None:
    # SvcOpts(8) Band(4) Channel(12) TGID(16) Source(24)
    result["type"] = (
        "GROUP_VOICE_GRANT"
        if op == TSBKOpcode.GRP_V_CH_GRANT
        else "GROUP_VOICE_GRANT_UPDATE"
    )
    _service_options(data[0], result)
    band = (data[1] >> 4) & 0xF
    chan = ((data[1] & 0x0F) << 8) | data[2]
    result["frequency_band"] = band
    result["channel_number"] = chan
    result["channel"] = (band << 12) | chan
    result["tgid"] = (data[3] << 8) | data[4]
    result["source_id"] = int.from_bytes(data[5:8], "big")


def _parse_uu_grant(data: bytes, result: dict[str, Any]) -> None:
    result["type"] = "UNIT_VOICE_GRANT"
    band = (data[0] >> 4) & 0xF
    chan = ((data[0] & 0x0F) << 8) | data[1]
    result["channel"] = (band << 12) | chan
    result["frequency_band"] = band
    result["channel_number"] = chan
    result["target"] = int.from_bytes(data[2:5], "big")
    result["source_id"] = int.from_bytes(data[5:8], "big")


def _parse_iden_up_vu(data: bytes, result: dict[str, Any], op: TSBKOpcode) -> None:
    # Ident(4) BW(4) Sign(1) TxOffset(13) Spacing(10) Base(32)
    result["type"] = (
        "IDENTIFIER_UPDATE" if op == TSBKOpcode.IDEN_UP else "IDENTIFIER_UPDATE_VU"
    )
    ident = (data[0] >> 4) & 0xF
    bw_code = data[0] & 0xF
    # Sign(1)+Magnitude(13): sign bit 1 = positive; magnitude is in units of
    # channel spacing (offset_hz = mag * spacing * 125), per SDRTrunk /
    # reference semantics — not fixed 0.25 MHz units.
    sign = 1.0 if (data[1] & 0x80) else -1.0
    tx_off = ((data[1] & 0x7F) << 6) | ((data[2] >> 2) & 0x3F)
    spacing = ((data[2] & 0x03) << 8) | data[3]
    base = int.from_bytes(data[4:8], "big")
    result["identifier"] = ident
    result["bandwidth_khz"] = {4: 6.25, 5: 12.5}.get(bw_code, 12.5)
    result["tx_offset_mhz"] = sign * tx_off * spacing * 125 * 1e-6
    result["channel_spacing_khz"] = spacing * 0.125
    result["base_freq_mhz"] = base * 5e-6  # 5 Hz units -> MHz
    return


def _parse_iden_up_tdma(data: bytes, result: dict[str, Any]) -> None:
    result["type"] = "IDENTIFIER_UPDATE_TDMA"
    ident = (data[0] >> 4) & 0xF
    channel_type = data[0] & 0xF
    # Sign(1)+Magnitude(13) in units of channel spacing, like IDEN_UP_VU
    # (sign bit 1 = positive) — not 14-bit two's complement.
    sign = 1.0 if (data[1] & 0x80) else -1.0
    tx_off = ((data[1] & 0x7F) << 6) | ((data[2] >> 2) & 0x3F)
    spacing = ((data[2] & 0x03) << 8) | data[3]
    base = int.from_bytes(data[4:8], "big")
    result["identifier"] = ident
    result["channel_type"] = channel_type
    result["slots_per_carrier"] = {0: 1, 1: 1, 2: 1, 3: 2, 4: 4, 5: 2}.get(
        channel_type, 1
    )
    result["bandwidth_khz"] = 12.5 if channel_type in (0, 1, 2, 3, 5) else 6.25
    result["tx_offset_mhz"] = sign * tx_off * spacing * 125 * 1e-6
    result["channel_spacing_khz"] = spacing * 0.125
    result["base_freq_mhz"] = base * 5e-6


def _parse_rfss_status(data: bytes, result: dict[str, Any]) -> None:
    # LRA(8) _(3) ActiveNet(1) SysID(12) RFSS(8) Site(8) Band(4) Chan(12) SvcClass(8)
    result["type"] = "RFSS_STATUS"
    result["lra"] = data[0]
    # bit 27 (spec); the reference uses 0x08 which collides with system_id
    result["active_network"] = bool(data[1] & 0x10)
    result["system_id"] = ((data[1] & 0x0F) << 8) | data[2]
    result["rfss_id"] = data[3]
    result["site_id"] = data[4]
    band = (data[5] >> 4) & 0xF
    chan = ((data[5] & 0x0F) << 8) | data[6]
    result["frequency_band"] = band
    result["channel_number"] = chan
    result["channel"] = (band << 12) | chan
    result["service_class"] = data[7]


def _parse_net_status(data: bytes, result: dict[str, Any]) -> None:
    # LRA(8) WACN(20) SysID(12) Band(4) Chan(12) SvcClass(8)
    result["type"] = "NETWORK_STATUS"
    result["lra"] = data[0]
    result["wacn"] = (data[1] << 12) | (data[2] << 4) | ((data[3] >> 4) & 0xF)
    result["system_id"] = ((data[3] & 0x0F) << 8) | data[4]
    band = (data[5] >> 4) & 0xF
    chan = ((data[5] & 0x0F) << 8) | data[6]
    result["frequency_band"] = band
    result["channel_number"] = chan
    result["channel"] = (band << 12) | chan
    result["service_class"] = data[7]


def _parse_adjacent_status(data: bytes, result: dict[str, Any]) -> None:
    result["type"] = "ADJACENT_STATUS"
    result["lra"] = data[0]
    result["system_id"] = ((data[1] & 0x0F) << 8) | data[2]
    result["rfss_id"] = data[3]
    result["site_id"] = data[4]
    band = (data[5] >> 4) & 0xF
    chan = ((data[5] & 0x0F) << 8) | data[6]
    result["frequency_band"] = band
    result["channel_number"] = chan
    result["channel"] = (band << 12) | chan
    result["service_class"] = data[7]


# ---------------------------------------------------------------------------
# Synthesis helpers (tests / control-channel encoder)
# ---------------------------------------------------------------------------


def make_group_grant_data(
    tgid: int,
    source_id: int,
    band: int,
    channel_number: int,
    emergency: bool = False,
    encrypted: bool = False,
) -> bytes:
    svc = (0x80 if emergency else 0) | (0x40 if encrypted else 0)
    return bytes(
        [
            svc,
            ((band & 0xF) << 4) | ((channel_number >> 8) & 0xF),
            channel_number & 0xFF,
            (tgid >> 8) & 0xFF,
            tgid & 0xFF,
            (source_id >> 16) & 0xFF,
            (source_id >> 8) & 0xFF,
            source_id & 0xFF,
        ]
    )


def make_iden_up_data(
    identifier: int,
    base_freq_mhz: float,
    channel_spacing_khz: float = 12.5,
    tx_offset_mhz: float = 0.0,
    bandwidth_code: int = 5,
) -> bytes:
    sign = 1 if tx_offset_mhz >= 0 else 0
    tx_off = int(round(abs(tx_offset_mhz) / 0.25))
    spacing = int(round(channel_spacing_khz / 0.125))
    base = int(round(base_freq_mhz / 5e-6))
    return bytes(
        [
            ((identifier & 0xF) << 4) | (bandwidth_code & 0xF),
            (sign << 7) | ((tx_off >> 6) & 0x7F),
            ((tx_off & 0x3F) << 2) | ((spacing >> 8) & 0x03),
            spacing & 0xFF,
            (base >> 24) & 0xFF,
            (base >> 16) & 0xFF,
            (base >> 8) & 0xFF,
            base & 0xFF,
        ]
    )


def make_rfss_status_data(
    system_id: int, rfss_id: int, site_id: int, band: int, channel_number: int
) -> bytes:
    return bytes(
        [
            0,
            0x10 | ((system_id >> 8) & 0x0F),
            system_id & 0xFF,
            rfss_id & 0xFF,
            site_id & 0xFF,
            ((band & 0xF) << 4) | ((channel_number >> 8) & 0xF),
            channel_number & 0xFF,
            0x70,
        ]
    )


def make_iden_up_tdma_data(
    identifier: int,
    base_freq_mhz: float,
    channel_type: int = 3,  # 3 = Phase 2 H-DQPSK, 2 slots
    channel_spacing_khz: float = 12.5,
    tx_offset_mhz: float = 0.0,
) -> bytes:
    tx_off = int(round(abs(tx_offset_mhz) / 0.25))
    spacing = int(round(channel_spacing_khz / 0.125))
    base = int(round(base_freq_mhz / 5e-6))
    return bytes(
        [
            ((identifier & 0xF) << 4) | (channel_type & 0xF),
            (tx_off >> 6) & 0xFF,
            ((tx_off & 0x3F) << 2) | ((spacing >> 8) & 0x03),
            spacing & 0xFF,
            (base >> 24) & 0xFF,
            (base >> 16) & 0xFF,
            (base >> 8) & 0xFF,
            base & 0xFF,
        ]
    )


def make_adjacent_status_data(
    system_id: int, rfss_id: int, site_id: int, band: int, channel_number: int,
    lra: int = 0, service_class: int = 0x70,
) -> bytes:
    return bytes(
        [
            lra & 0xFF,
            (system_id >> 8) & 0x0F,
            system_id & 0xFF,
            rfss_id & 0xFF,
            site_id & 0xFF,
            ((band & 0xF) << 4) | ((channel_number >> 8) & 0xF),
            channel_number & 0xFF,
            service_class & 0xFF,
        ]
    )


def make_sys_srv_data(services: int) -> bytes:
    return bytes([0]) + int(services).to_bytes(3, "big") + bytes(4)


def iden_from_parsed(p: dict[str, Any]) -> ChannelIdentifier:
    return ChannelIdentifier(
        identifier=p["identifier"],
        bandwidth_khz=p["bandwidth_khz"],
        tx_offset_mhz=p["tx_offset_mhz"],
        channel_spacing_khz=p["channel_spacing_khz"],
        base_freq_mhz=p["base_freq_mhz"],
        slots_per_carrier=int(p.get("slots_per_carrier", 1)),
    )
