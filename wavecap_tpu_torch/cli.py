"""Command-line interface: offline/batch operation.

Reference parity (``cli.py:1134-1215``): ``list-devices``, ``capture-iq``,
``demod`` (offline IQ file -> audio WAV, the reference's decode-audio),
``decode-iq`` (offline P25 decode with TSBK statistics), ``trunking``
(headless trunking with stats), ``serve`` (the server).

Usage: ``python -m wavecap_tpu_torch <command> ...``

In the port every command runs on the torch device that
``WAVECAP_TORCH_DEVICE`` names (``utils/torchenv.py:entry_device``: the
CUDA card unless ``cpu``); ``demod`` and ``decode-iq`` / ``decode-audio``
step the port's demodulators eagerly on it, block by block with their
state carried.

The port's copy of ``wavecap_tpu/cli.py``, with the same public names.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def cmd_list_devices(args) -> int:
    from wavecap_tpu_torch.utils.config import load_config
    from wavecap_tpu_torch.server.app import create_device_driver

    cfg = load_config(args.config)
    if args.driver:
        cfg.device.driver = args.driver
    driver = create_device_driver(cfg)
    for d in driver.enumerate():
        print(f"{d.id:12s} {d.driver:8s} {d.label}")
    return 0


def cmd_capture_iq(args) -> int:
    """Capture IQ from a device to a 2-channel WAV."""
    from wavecap_tpu_torch.utils.config import load_config
    from wavecap_tpu_torch.server.app import create_device_driver
    from wavecap_tpu_torch.devices.base import DeviceConfig
    from wavecap_tpu_torch.utils.wavio import write_iq_wav

    cfg = load_config(args.config)
    if args.driver:
        cfg.device.driver = args.driver
    driver = create_device_driver(cfg)
    devices = driver.enumerate()
    if not devices:
        print("no devices", file=sys.stderr)
        return 1
    dev = driver.open(args.device or devices[0].id)
    dev.configure(
        DeviceConfig(center_hz=args.freq, sample_rate=args.rate, gain_db=args.gain)
    )
    stream = dev.start_stream()
    n = int(args.duration * args.rate)
    chunks = []
    got = 0
    while got < n:
        samples, overflow = stream.read(min(n - got, args.rate // 10))
        chunks.append(samples)
        got += len(samples)
    stream.close()
    iq = np.concatenate(chunks)[:n]
    write_iq_wav(args.output, iq, args.rate)
    print(f"wrote {len(iq)} samples @ {args.rate} Hz to {args.output}")
    return 0


def _read_iq(path: str, rate: int | None):
    from wavecap_tpu_torch.utils.wavio import read_iq_wav

    p = Path(path)
    if p.suffix.lower() == ".wav":
        iq, file_rate = read_iq_wav(p)
        return iq, file_rate
    if p.suffix.lower() in (".cf32", ".fc32"):
        raw = np.fromfile(p, np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64), rate
    if p.suffix.lower() in (".cs16", ".sc16"):
        raw = np.fromfile(p, np.int16).astype(np.float32) / 32768.0
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64), rate
    raise SystemExit(f"unsupported IQ format: {p.suffix}")


def _c4fm_step(cfg, device):
    """C4FM step taking a complex64 host block, plus its state on ``device``.

    The block crosses to the device as one complex tensor; the step runs
    the port's ``c4fm_demodulate`` eagerly (K12 on the card) and returns
    the soft symbols on the host."""
    import torch

    from wavecap_tpu_torch.models.p25.c4fm import c4fm_demodulate, c4fm_init

    def step(x, st):
        soft, dibits, st = c4fm_demodulate(torch.from_numpy(x).to(device), st, cfg)
        return soft.cpu().numpy(), dibits, st

    return step, c4fm_init(cfg, device=device)


def _parse_dsp_value(v: str):
    """CLI --dsp value: bool / number / bare string."""
    low = v.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def cmd_demod(args) -> int:
    """Offline demodulation: IQ file -> audio WAV."""

    from wavecap_tpu_torch import models
    from wavecap_tpu_torch.utils.wavio import write_audio_wav

    iq, rate = _read_iq(args.input, args.rate)
    if rate is None:
        raise SystemExit("--rate required for raw IQ files")
    if args.offset:
        # host-side mix: exact and cheap; the device sees only the demod
        t = np.arange(len(iq)) / rate
        iq = (iq * np.exp(-2j * np.pi * args.offset * t)).astype(np.complex64)
    spec = models.get_demod(args.mode)
    dsp: dict = {}
    for kv in args.dsp or []:
        k, _, v = kv.partition("=")
        if not _:
            raise SystemExit(f"--dsp expects field=value, got {kv!r}")
        dsp[k.strip()] = _parse_dsp_value(v.strip())
    if args.notch:
        dsp["notch_frequencies"] = tuple(
            float(f) for f in args.notch.split(",") if f.strip()
        )
    cfg = models.make_config(args.mode, rate, audio_rate=args.audio_rate, **dsp)
    # fixed-size blocks through the port's demod, eager on the device:
    # streaming state carries across blocks exactly like the live capture
    # path.  IQ crosses the host->device boundary as one complex tensor a
    # block and the state is created on the device.
    import torch
    from math import gcd

    unit = (int(rate) // gcd(int(rate), int(args.audio_rate))) * 64
    block = max(unit, (int(rate) // 5 // unit) * unit)  # ~0.2 s
    device = args.torch_device

    def step(x, st):
        y, st = spec.demod(torch.from_numpy(x).to(device), st, cfg)
        return y.cpu().numpy(), st

    state = spec.init(cfg, device=device)
    t0 = time.perf_counter()
    parts = []
    n_blocks = len(iq) // block
    for i in range(n_blocks):
        row = np.ascontiguousarray(iq[i * block : (i + 1) * block])
        y, state = step(row, state)
        parts.append(np.asarray(y))
    rem = len(iq) - n_blocks * block
    if rem >= unit:
        row = np.ascontiguousarray(
            iq[n_blocks * block :][: (rem // unit) * unit]
        )
        y, state = step(row, state)
        parts.append(np.asarray(y))
    audio = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    dt = time.perf_counter() - t0
    write_audio_wav(args.output, audio, args.audio_rate)
    print(
        f"demodulated {len(iq)/rate:.1f}s of {args.mode} in {dt:.1f}s "
        f"({len(iq)/rate/dt:.1f}x realtime) -> {args.output}"
    )
    return 0


def cmd_decode_iq(args) -> int:
    """Offline P25 decode: IQ file -> frame/TSBK statistics (+ JSON)."""
    from scipy import signal as sps

    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk
    from wavecap_tpu_torch.decoders.framer import P25Framer
    from wavecap_tpu_torch.models.p25.c4fm import C4fmConfig, c4fm_init, c4fm_demodulate

    iq, rate = _read_iq(args.input, args.rate)
    if rate is None:
        raise SystemExit("--rate required for raw IQ files")
    if args.offset:
        t = np.arange(len(iq)) / rate
        iq = (iq * np.exp(-2j * np.pi * args.offset * t)).astype(np.complex64)
    # resample to 48 kHz (10 SPS)
    if rate != 48_000:
        from math import gcd

        g = gcd(int(rate), 48_000)
        iq = sps.resample_poly(iq, 48_000 // g, int(rate) // g).astype(np.complex64)
    cfg = C4fmConfig(sample_rate=48_000)
    demod, state = _c4fm_step(cfg, args.torch_device)
    framer = P25Framer()
    stats = {"frames": 0, "tsdu": 0, "ldu": 0, "tsbk": 0, "tsbk_crc_ok": 0, "by_duid": {}}
    messages = []
    block = 48_000 // 2
    n_blocks = len(iq) // block
    t0 = time.perf_counter()
    for i in range(n_blocks):
        soft, _, state = demod(
            np.ascontiguousarray(iq[i * block : (i + 1) * block]),
            state,
        )
        for frame in framer.process(np.asarray(soft)):
            stats["frames"] += 1
            name = frame.duid.name
            stats["by_duid"][name] = stats["by_duid"].get(name, 0) + 1
            if frame.duid == pf.DUID.TSDU:
                stats["tsdu"] += 1
                payload = pf.remove_status_dibits(frame.dibits[57:], 57)
                soft_payload = pf.remove_status_dibits(frame.soft[57:], 57)
                for b in pf.decode_tsbk_payload(payload, soft_payload):
                    stats["tsbk"] += 1
                    if b.crc_valid:
                        stats["tsbk_crc_ok"] += 1
                        messages.append(tsbk.parse_tsbk(b.opcode, b.mfid, b.data))
            elif frame.duid in (pf.DUID.LDU1, pf.DUID.LDU2):
                stats["ldu"] += 1
            elif frame.duid == pf.DUID.PDU:
                payload = pf.remove_status_dibits(frame.dibits[57:], 57)
                soft_payload = pf.remove_status_dibits(frame.soft[57:], 57)
                pdu = pf.decode_pdu(payload, soft_payload)
                if pdu is not None:
                    stats["pdu"] = stats.get("pdu", 0) + 1
                    if pdu.header.crc_valid and pdu.crc32_valid:
                        stats["pdu_crc_ok"] = stats.get("pdu_crc_ok", 0) + 1
                        messages.append(
                            {
                                "type": "PDU",
                                "sap": pdu.header.sap,
                                "llid": pdu.header.llid,
                                "fmt": pdu.header.fmt,
                                "data_hex": pdu.data.hex(),
                            }
                        )
    dt = time.perf_counter() - t0
    stats["sync_count"] = framer.sync_count
    stats["crc_rate"] = round(
        stats["tsbk_crc_ok"] / stats["tsbk"], 3
    ) if stats["tsbk"] else 0.0
    stats["realtime_x"] = round(len(iq) / 48_000 / dt, 2)
    print(json.dumps(stats, indent=2))
    if args.messages:
        Path(args.messages).write_text(json.dumps(messages, indent=2))
        print(f"wrote {len(messages)} messages to {args.messages}")
    return 0


def cmd_decode_audio(args) -> int:
    """P25 IQ file -> voice audio WAV (reference ``cli.py:409`` decode-audio).

    Demodulates C4FM, frames LDUs, runs IMBE codeword FEC and — when a
    vocoder library is present — synthesizes PCM.  Without one, the raw
    codewords are persisted as ``.imbe`` next to the output."""
    from scipy import signal as sps

    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders.framer import P25Framer
    from wavecap_tpu_torch.decoders.voice import VoiceDecoder, vocoder_available
    from wavecap_tpu_torch.models.p25.c4fm import C4fmConfig, c4fm_init, c4fm_demodulate
    from wavecap_tpu_torch.utils.wavio import write_audio_wav

    iq, rate = _read_iq(args.input, args.rate)
    if rate is None:
        raise SystemExit("--rate required for raw IQ files")
    if rate != 48_000:
        from math import gcd

        g = gcd(int(rate), 48_000)
        iq = sps.resample_poly(iq, 48_000 // g, int(rate) // g).astype(np.complex64)
    cfg = C4fmConfig(sample_rate=48_000)
    demod, state = _c4fm_step(cfg, args.torch_device)
    framer = P25Framer()
    decoder = VoiceDecoder()
    pcm_chunks: list[np.ndarray] = []
    imbe_frames: list[np.ndarray] = []
    block = 24_000
    for i in range(len(iq) // block):
        soft, _, state = demod(
            np.ascontiguousarray(iq[i * block : (i + 1) * block]),
            state,
        )
        for frame in framer.process(np.asarray(soft)):
            if frame.duid not in (pf.DUID.LDU1, pf.DUID.LDU2):
                continue
            ldu = pf.decode_ldu(frame.dibits)
            if ldu is None:
                continue
            imbe_frames.extend(np.asarray(cw, np.uint8) for cw in ldu.imbe_codewords)
            pcm = decoder.decode_codewords(ldu.imbe_codewords)
            if pcm is not None and len(pcm):
                pcm_chunks.append(pcm)
    if pcm_chunks:
        audio = np.concatenate(pcm_chunks)
        write_audio_wav(args.output, audio, 8000)
        print(f"wrote {len(audio)/8000:.1f}s voice audio to {args.output}")
    else:
        out = Path(args.output).with_suffix(".imbe")
        if imbe_frames:
            np.packbits(np.concatenate(imbe_frames)).tofile(out)
        print(
            f"vocoder {'absent' if not vocoder_available() else 'produced no audio'}; "
            f"{len(imbe_frames)} IMBE codewords -> {out}"
        )
    print(f"frames={framer.frame_count} syncs={framer.sync_count}")
    return 0


def cmd_trunking(args) -> int:
    """Headless trunking with periodic stats (reference ``cli.py:864``)."""
    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.server.app import create_device_driver
    from wavecap_tpu_torch.trunking import TrunkingManager, TrunkingSystemConfig
    from wavecap_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    if args.driver:
        cfg.device.driver = args.driver
    if args.file:
        cfg.device.driver = "file"
        cfg.device.file_path = args.file
    mgr = CaptureManager(create_device_driver(cfg), device=args.torch_device)
    tm = TrunkingManager(mgr, state_dir=Path(args.state_dir))
    scfg = TrunkingSystemConfig.from_dict(
        {
            "id": args.id,
            "name": args.id,
            "control_channels": [float(f) for f in args.control],
            "center_hz": args.center,
            "sample_rate": int(args.rate),
            "recording_dir": args.recordings,
        }
    )
    sysm = tm.create_system(scfg)
    sysm.start()
    t0 = time.time()
    try:
        while args.duration <= 0 or time.time() - t0 < args.duration:
            remaining = (
                args.duration - (time.time() - t0) if args.duration > 0 else None
            )
            time.sleep(
                args.stats_interval
                if remaining is None
                else max(0.2, min(args.stats_interval, remaining))
            )
            s = sysm.status()
            print(
                json.dumps(
                    {
                        "t": round(time.time() - t0, 1),
                        "synced": s["synced"],
                        "nac": s["nac"],
                        "tsbk": s["tsbkCount"],
                        "crcRate": s["tsbkCrcRate"],
                        "calls": len(s["activeCalls"]),
                    }
                ),
                flush=True,
            )
    except KeyboardInterrupt:
        pass
    finally:
        tm.stop_all()
    s = sysm.status()
    print(json.dumps({"final": s}, default=str), flush=True)
    # native reader threads may be blocked in a stream read; skip the
    # interpreter teardown races they cause and exit cleanly now
    import os

    os._exit(0)


def cmd_serve(args) -> int:
    from wavecap_tpu_torch.server.__main__ import main as server_main

    sys.argv = ["wavecap_tpu_torch.server"] + (
        ["--config", args.config] if args.config else []
    ) + (["--port", str(args.port)] if args.port else []) + (
        ["--mesh", args.mesh] if getattr(args, "mesh", None) else []
    )
    return server_main(args.torch_device)


def _hz(v: str) -> int:
    """Integer rates/frequencies accepting SDR-style literals ("2.4e6")."""
    return int(float(v))


def main() -> int:
    from wavecap_tpu_torch.utils.torchenv import entry_device

    device = entry_device()
    p = argparse.ArgumentParser("wavecap_tpu", description=__doc__)
    p.add_argument("--config", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("list-devices")
    s.add_argument("--driver", default=None)
    s.set_defaults(fn=cmd_list_devices)

    s = sub.add_parser("capture-iq")
    s.add_argument("--driver", default=None)
    s.add_argument("--device", default=None)
    s.add_argument("--freq", type=float, required=True)
    s.add_argument("--rate", type=_hz, default=2_400_000)
    s.add_argument("--gain", type=float, default=None)
    s.add_argument("--duration", type=float, default=10.0)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_capture_iq)

    s = sub.add_parser("demod")
    s.add_argument("--input", required=True)
    s.add_argument("--rate", type=_hz, default=None)
    s.add_argument("--offset", type=float, default=0.0)
    s.add_argument("--mode", default="wbfm")
    s.add_argument("--audio-rate", type=_hz, default=48_000)
    s.add_argument(
        "--dsp", action="append", metavar="FIELD=VALUE",
        help="demod config override (snake_case), e.g. "
        "--dsp enable_deemphasis=false --dsp lowpass_hz=3000; repeatable",
    )
    s.add_argument(
        "--notch", default=None,
        help="comma-separated notch frequencies in Hz, e.g. 1000,2600",
    )
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_demod)

    s = sub.add_parser("decode-iq")
    s.add_argument("--input", required=True)
    s.add_argument("--rate", type=_hz, default=None)
    s.add_argument("--offset", type=float, default=0.0)
    s.add_argument("--messages", default=None)
    s.set_defaults(fn=cmd_decode_iq)

    s = sub.add_parser("decode-audio")
    s.add_argument("--input", required=True)
    s.add_argument("--rate", type=_hz, default=None)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_decode_audio)

    s = sub.add_parser("trunking")
    s.add_argument("--id", default="cli")
    s.add_argument("--driver", default=None)
    s.add_argument("--file", default=None, help="wideband IQ WAV to replay")
    s.add_argument("--control", nargs="+", required=True, help="control channel Hz")
    s.add_argument("--center", type=float, required=True)
    s.add_argument("--rate", type=float, default=2_400_000)
    s.add_argument("--duration", type=float, default=0, help="0 = run until ^C")
    s.add_argument("--stats-interval", type=float, default=5.0)
    s.add_argument("--state-dir", default="/tmp/wavecap_trunking")
    s.add_argument("--recordings", default=None)
    s.set_defaults(fn=cmd_trunking)

    s = sub.add_parser("serve")
    s.add_argument("--port", type=int, default=None)
    s.add_argument(
        "--mesh", default=None,
        help="run captures on the device mesh, e.g. stream=1,time=8",
    )
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args()
    args.torch_device = device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
