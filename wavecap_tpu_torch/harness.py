"""End-to-end correctness harness (reference ``harness.py:42-120``).

Boots the in-process server with a chosen driver, creates a capture +
channel via REST, collects PCM over the audio WebSocket for a duration,
writes a WAV + JSON report with audio statistics.  Presets mirror the
reference harness (kexp = broadcast WBFM; tone = fake tone; marine = AM).

Run:  python -m wavecap_tpu_torch.harness --preset tone --duration 5

In the port the server runs on the torch device that
``WAVECAP_TORCH_DEVICE`` names (the CUDA card unless ``cpu``), and the
harness's client is the standard library's: REST over ``http.client``
and a minimal RFC 6455 client on the port's WebSocket frame codec
(``server/httpd.py``), so it runs without httpx and websockets.

The port's copy of ``wavecap_tpu/harness.py``, with the same public names.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import contextlib
import hashlib
import http.client
import json
import os
import struct
import sys
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from urllib.parse import urlsplit

import numpy as np

from wavecap_tpu_torch.server.app import AppServer
from wavecap_tpu_torch.server.httpd import WS_MAGIC, WebSocket
from wavecap_tpu_torch.utils.config import config_from_dict
from wavecap_tpu_torch.utils.wavio import write_audio_wav


PRESETS = {
    "tone": {
        "driver": "fake",
        "center_hz": 155e6,
        "sample_rate": 800_000,
        "channel": {"mode": "nbfm", "frequencyHz": 155.1e6},
        "stations": [
            {"offset_hz": 100_000.0, "kind": "nbfm", "tone_hz": 1000.0}
        ],
    },
    "kexp": {
        # broadcast WBFM shape (fake station unless an IQ file is given)
        "driver": "fake",
        "center_hz": 90.3e6,
        "sample_rate": 2_400_000,
        "channel": {"mode": "wbfm", "frequencyHz": 90.3e6 + 100_000},
        "stations": [
            {
                "offset_hz": 100_000.0,
                "kind": "wbfm",
                "tone_hz": 440.0,
                "deviation_hz": 75_000.0,
            }
        ],
    },
    "marine": {
        "driver": "fake",
        "center_hz": 156.8e6,
        "sample_rate": 800_000,
        "channel": {"mode": "am", "frequencyHz": 156.85e6},
        "stations": [{"offset_hz": 50_000.0, "kind": "am", "tone_hz": 700.0}],
    },
    # synthesized P25 control channel -> full trunking stack via REST:
    # lock, IDEN learn, voice grant -> call bookkeeping (reference's
    # harness has no trunking preset; this validates the whole control
    # plane end-to-end without hardware)
    "p25-trunk": {
        "driver": "fake",
        "trunking": True,
        "center_hz": 851.5e6,
        "sample_rate": 960_000,
        "cc_freq": 851.2e6,
        "nac": 0x293,
    },
    # Phase 2 system: CQPSK/LSM control channel through the dual-rate
    # capture (4800-baud CC + probe slots, 6000-baud H-DQPSK voice bank)
    "p25-phase2-trunk": {
        "driver": "fake",
        "trunking": True,
        "protocol": "p25_phase2",
        "center_hz": 851.5e6,
        "sample_rate": 960_000,
        "cc_freq": 851.2e6,
        "nac": 0x293,
    },
}


def _make_p25_cc_iq(
    capture_rate: int, offset_hz: float, nac: int, modulation: str = "c4fm"
) -> np.ndarray:
    """Seamlessly loopable control-channel IQ: TSDUs with IDEN + group
    grant + RFSS.

    The loop must be wrap-continuous or every loop period corrupts a
    frame at the seam (observed as a periodic TSBK CRC failure every
    2.25 s): the RRC shaping is applied as a *circular* convolution, the
    FM phase is closed to a multiple of 2pi by a sub-Hz frequency trim,
    and the channel-offset mixer completes an integer number of cycles
    over the loop.
    """
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm_cyclic

    iden = pf.encode_tsbk_block(
        tsbk.TSBKOpcode.IDEN_UP,
        tsbk.make_iden_up_data(
            identifier=1, base_freq_mhz=851.0, channel_spacing_khz=12.5,
            tx_offset_mhz=-45.0,
        ),
        last=False,
    )
    grant = pf.encode_tsbk_block(
        tsbk.TSBKOpcode.GRP_V_CH_GRANT,
        tsbk.make_group_grant_data(
            tgid=2001, source_id=700123, band=1, channel_number=56
        ),
        last=False,
    )
    rfss = pf.encode_tsbk_block(
        tsbk.TSBKOpcode.RFSS_STS_BCAST,
        tsbk.make_rfss_status_data(
            system_id=0x123, rfss_id=1, site_id=7, band=1, channel_number=16
        ),
        last=True,
    )
    dibits = np.concatenate(
        [pf.build_tsdu_frame(nac, [iden, grant, rfss]) for _ in range(30)]
    )
    if modulation == "cqpsk":
        from wavecap_tpu_torch.models.p25.cqpsk import modulate_cqpsk_cyclic

        iq = modulate_cqpsk_cyclic(dibits, capture_rate)
    else:
        iq = modulate_c4fm_cyclic(dibits, capture_rate)
    n = len(iq)
    # integer number of mixer cycles over the loop -> phase-continuous wrap
    cycles = round(offset_hz * n / capture_rate)
    t = np.arange(n) / n
    return (iq * np.exp(2j * np.pi * cycles * t)).astype(np.complex64)


class _Reply:
    """What the harness reads of an HTTP response."""

    def __init__(self, status_code: int, body: bytes):
        self.status_code = status_code
        self.text = body.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.text)


class _Client:
    """JSON-over-HTTP client on ``http.client``: each request on its own
    connection, run on a thread so the server's event loop stays free."""

    def __init__(self, base_url: str, timeout: float):
        u = urlsplit(base_url)
        self.host, self.port, self.prefix = u.hostname, u.port, u.path
        self.timeout = timeout

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    def _request(self, method: str, path: str, body) -> _Reply:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            data = None if body is None else json.dumps(body).encode()
            headers = {} if data is None else {"Content-Type": "application/json"}
            conn.request(method, self.prefix + path, body=data, headers=headers)
            r = conn.getresponse()
            return _Reply(r.status, r.read())
        finally:
            conn.close()

    async def get(self, path: str) -> _Reply:
        return await asyncio.to_thread(self._request, "GET", path, None)

    async def post(self, path: str, json=None) -> _Reply:
        return await asyncio.to_thread(self._request, "POST", path, json)


class _WsClient(WebSocket):
    """The client end of a WebSocket on the server's frame codec: it
    reads as the server's end does and masks what it sends (RFC 6455)."""

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        n = len(payload)
        header = bytearray([0x80 | opcode])
        if n < 126:
            header.append(0x80 | n)
        elif n < 65536:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.writer.write(bytes(header) + mask + body)
        await self.writer.drain()

    async def recv(self) -> bytes:
        msg = await super().recv()
        if msg is None:
            raise ConnectionError("websocket closed")
        return msg[1]


@contextlib.asynccontextmanager
async def _ws_connect(uri: str, open_timeout: float):
    """Open a WebSocket (``ws://host:port/path``): the upgrade handshake,
    its accept key checked."""
    u = urlsplit(uri)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(u.hostname, u.port), open_timeout
    )
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write(
        f"GET {u.path} HTTP/1.1\r\nHost: {u.hostname}:{u.port}\r\n"
        f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n".encode()
    )
    head = (await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), open_timeout)).decode("latin1")
    accept = base64.b64encode(hashlib.sha1((key + WS_MAGIC).encode()).digest()).decode()
    if head.split(" ", 2)[1] != "101" or accept not in head:
        writer.close()
        raise ConnectionError(f"websocket upgrade refused: {head.splitlines()[0]}")
    ws = _WsClient(reader, writer)
    try:
        yield ws
    finally:
        await ws.close()


async def run_trunking_harness(args, device=None) -> dict:
    """P25 trunking preset: boot server, create system, report lock/calls."""
    preset = PRESETS[args.preset]
    cfg = config_from_dict(
        {"server": {"host": "127.0.0.1", "port": 0}, "device": {"driver": "fake"}}
    )
    server = AppServer(cfg, device=device)
    from wavecap_tpu_torch.devices import FakeDriver, FakeStation

    center, rate = preset["center_hz"], preset["sample_rate"]
    station = FakeStation(offset_hz=0.0, kind="iq_loop", amplitude=1.0)
    station.iq_loop = _make_p25_cc_iq(
        rate,
        preset["cc_freq"] - center,
        preset["nac"],
        modulation=(
            "cqpsk" if preset.get("protocol") == "p25_phase2" else "c4fm"
        ),
    )
    server.state.driver = FakeDriver(stations=[station])
    server.state.captures.driver = server.state.driver
    await server.start()
    base = f"http://127.0.0.1:{server.port}/api/v1"
    t0 = time.perf_counter()
    try:
        async with _Client(base_url=base, timeout=120) as client:
            r = await client.post(
                "/trunking/systems",
                json={
                    "id": "harness", "control_channels": [preset["cc_freq"]],
                    "center_hz": center, "sample_rate": rate,
                    "protocol": preset.get("protocol", "p25_phase1"),
                    "recording_dir": str(Path(args.out_dir) / "rec"),
                    "autoStart": True,
                },
            )
            assert r.status_code < 300, r.text
            deadline = time.time() + args.duration + 300  # cold build headroom
            st: dict = {}
            while time.time() < deadline:
                st = (await client.get("/trunking/systems/harness")).json()
                calls = (await client.get(
                    "/trunking/systems/harness/calls"
                )).json()
                n_calls = len(calls.get("active", [])) + len(
                    calls.get("history", [])
                )
                # exit only after the receiver reaches steady state: the
                # lifetime CRC rate at the instant of first lock is
                # dominated by the acquisition transient (and flaky);
                # tsbkCountSteady >= 30 is ~10 TSDUs of post-lock signal
                if (
                    st.get("synced")
                    and st.get("tsbkCountSteady", 0) >= 30
                    and n_calls
                ):
                    break
                await asyncio.sleep(0.5)
            report = {
                "preset": args.preset,
                "synced": bool(st.get("synced")),
                "nac": st.get("nac"),
                "tsbkCount": st.get("tsbkCount"),
                "tsbkCrcRate": st.get("tsbkCrcRate"),
                "tsbkCountSteady": st.get("tsbkCountSteady"),
                "tsbkCrcRateSteady": st.get("tsbkCrcRateSteady"),
                "systemId": st.get("systemId"),
                "siteId": st.get("siteId"),
                "calls": n_calls,
                "wall_s": round(time.perf_counter() - t0, 1),
            }
            out_dir = Path(args.out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"harness_{args.preset}.json").write_text(
                json.dumps(report, indent=2)
            )
            return report
    finally:
        await server.stop()


@dataclass
class HarnessReport:
    preset: str
    duration_s: float
    samples: int
    audio_rate: int
    rms: float
    peak: float
    dominant_hz: float
    wav_path: str
    realtime_factor: float


async def run_harness(args, device=None) -> HarnessReport:
    preset = PRESETS[args.preset]
    cfg = config_from_dict(
        {
            "server": {"host": "127.0.0.1", "port": 0},
            "device": {
                "driver": "file" if args.iq_file else preset["driver"],
                "file_path": args.iq_file,
            },
        }
    )
    server = AppServer(cfg, device=device)
    if not args.iq_file and preset["driver"] == "fake":
        from wavecap_tpu_torch.devices import FakeDriver, FakeStation

        server.state.driver = FakeDriver(
            stations=[FakeStation(**s) for s in preset["stations"]]
        )
        server.state.captures.driver = server.state.driver
    await server.start()
    base = f"http://127.0.0.1:{server.port}/api/v1"
    try:
        async with _Client(base_url=base, timeout=60) as client:
            r = await client.post(
                "/captures",
                json={
                    "centerHz": preset["center_hz"],
                    "sampleRate": preset["sample_rate"],
                },
            )
            cap = r.json()
            r = await client.post(
                f"/captures/{cap['id']}/channels", json=preset["channel"]
            )
            ch = r.json()
            await client.post(f"/captures/{cap['id']}/start")

            t0 = time.perf_counter()
            pcm_chunks: list[bytes] = []
            uri = f"ws://127.0.0.1:{server.port}/api/v1/stream/channels/{ch['id']}"
            first_timeout = float(os.environ.get("WAVECAP_WS_TIMEOUT", "600"))
            async with _ws_connect(uri, open_timeout=120) as ws:
                need = int(args.duration * 48_000) * 2
                got = 0
                while got < need:
                    data = await asyncio.wait_for(ws.recv(), timeout=first_timeout)
                    pcm_chunks.append(data)
                    got += len(data)
            wall = time.perf_counter() - t0

        audio = np.frombuffer(b"".join(pcm_chunks), np.int16).astype(np.float32) / 32768.0
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        wav_path = out_dir / f"harness_{args.preset}.wav"
        write_audio_wav(wav_path, audio, 48_000)

        seg = audio[len(audio) // 4 :]
        spec = np.abs(np.fft.rfft((seg - seg.mean()) * np.hanning(len(seg))))
        freqs = np.fft.rfftfreq(len(seg), 1 / 48_000)
        report = HarnessReport(
            preset=args.preset,
            duration_s=args.duration,
            samples=len(audio),
            audio_rate=48_000,
            rms=float(np.sqrt(np.mean(seg**2))),
            peak=float(np.abs(seg).max()),
            dominant_hz=float(freqs[int(np.argmax(spec))]),
            wav_path=str(wav_path),
            realtime_factor=round(args.duration / wall, 2),
        )
        (out_dir / f"harness_{args.preset}.json").write_text(
            json.dumps(asdict(report), indent=2)
        )
        return report
    finally:
        await server.stop()


def main() -> int:
    from wavecap_tpu_torch.utils.torchenv import entry_device

    device = entry_device()
    p = argparse.ArgumentParser("wavecap_tpu harness")
    p.add_argument("--preset", choices=sorted(PRESETS), default="tone")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--iq-file", default=None)
    p.add_argument("--out-dir", default="harness_out")
    args = p.parse_args()
    if PRESETS[args.preset].get("trunking"):
        out = asyncio.run(run_trunking_harness(args, device))
        print(json.dumps(out, indent=2))
        return 0 if out.get("synced") and out.get("calls") else 1
    report = asyncio.run(run_harness(args, device))
    print(json.dumps(asdict(report), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
