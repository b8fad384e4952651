"""The port's CLI (``wavecap_tpu_torch/cli.py``, ``python -m
wavecap_tpu_torch``) against the JAX package's, on the CPU
(``WAVECAP_TORCH_DEVICE=cpu``).

Parity, each command through both CLIs on the same seeded input files:

- ``demod`` for ``wbfm``, ``nbfm``, ``am`` and ``sam`` (the registry's
  demods stepped eagerly block by block, the reference's block size and
  carried state): the port's WAV >= 50 dB (``snr_db``) against the
  reference's, the same length and rate;
- ``decode-iq`` on a C4FM control channel: the printed statistics equal
  but ``realtime_x`` (a wall-clock rate), the messages file equal;
- ``decode-audio`` on C4FM voice (LDUs): the same frame and sync counts
  and the same output file kind, the audio >= 50 dB.

Then ``tests/test_cli.py``'s cases run on the port's CLI (each class a
subclass of the reference's, its ``cli`` the port's).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.test_cli as ref_cli
from tests.conftest import snr_db
from wavecap_tpu import cli as jcli
from wavecap_tpu.decoders import p25_frames as pf
from wavecap_tpu.decoders import p25_tsbk as tsbk
from wavecap_tpu.decoders import p25_voice as p25v
from wavecap_tpu_torch import cli as tcli
from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm
from wavecap_tpu_torch.utils.wavio import read_audio_wav, write_iq_wav

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("WAVECAP_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(ref_cli, "cli", tcli)


def run(monkeypatch, capsys, mod, *argv) -> tuple[int, str]:
    monkeypatch.setattr(sys, "argv", ["wavecap_tpu", *argv])
    rc = mod.main()
    return rc, capsys.readouterr().out


# --- demod ---------------------------------------------------------------------------------


def demod_scene(mode: str, rng) -> tuple[np.ndarray, int]:
    """1 s of the mode's signal with a 1 kHz program, plus seeded noise."""
    rate = 240_000 if mode == "wbfm" else 48_000
    t = np.arange(rate) / rate
    prog = np.sin(2 * np.pi * 1000.0 * t)
    if mode in ("wbfm", "nbfm"):
        dev = 75e3 if mode == "wbfm" else 2.5e3
        iq = np.exp(2j * np.pi * dev * np.cumsum(0.8 * prog) / rate)
    else:
        iq = (1.0 + 0.6 * prog) * np.exp(2j * np.pi * 150.0 * t)
    noise = rng.standard_normal(rate) + 1j * rng.standard_normal(rate)
    return (0.5 * iq + 0.01 * noise).astype(np.complex64), rate


@pytest.mark.parametrize("mode", ["wbfm", "nbfm", "am", "sam"])
def test_demod_matches_reference(monkeypatch, capsys, tmp_path, mode):
    iq, rate = demod_scene(mode, np.random.default_rng(18))
    src = tmp_path / "in.wav"
    write_iq_wav(src, iq, rate)
    out = {}
    for name, mod in (("ref", jcli), ("port", tcli)):
        dst = tmp_path / f"{name}.wav"
        rc, text = run(monkeypatch, capsys, mod, "demod", "--input", str(src), "--mode", mode, "--output", str(dst))
        assert rc == 0 and text.startswith(f"demodulated 1.0s of {mode}")
        out[name] = read_audio_wav(dst)
    (ra, rr), (pa, pr) = out["ref"], out["port"]
    assert pr == rr == 48_000 and pa.shape == ra.shape and len(pa) >= 0.9 * 48_000
    assert snr_db(ra, pa) >= 50.0, snr_db(ra, pa)


# --- decode-iq and decode-audio ------------------------------------------------------------


def control_channel_wav(path: Path) -> None:
    """``tests/test_cli.py``'s 30 TSDUs (IDEN, a grant, RFSS status) as C4FM
    at 48 kHz, plus seeded noise."""
    frames = []
    for _ in range(30):
        iden = pf.encode_tsbk_block(tsbk.TSBKOpcode.IDEN_UP,
                                    tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.0), last=False)
        grant = pf.encode_tsbk_block(tsbk.TSBKOpcode.GRP_V_CH_GRANT,
                                     tsbk.make_group_grant_data(tgid=101, source_id=7, band=1, channel_number=3),
                                     last=False)
        rfss = pf.encode_tsbk_block(tsbk.TSBKOpcode.RFSS_STS_BCAST,
                                    tsbk.make_rfss_status_data(system_id=0x123, rfss_id=1, site_id=7, band=1,
                                                               channel_number=0), last=True)
        frames.append(pf.build_tsdu_frame(0x293, [iden, grant, rfss]))
    iq = modulate_c4fm(np.concatenate(frames), 48_000)
    rng = np.random.default_rng(18)
    iq = iq + 0.02 * (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
    write_iq_wav(path, iq.astype(np.complex64), 48_000)


def test_decode_iq_matches_reference(monkeypatch, capsys, tmp_path):
    src = tmp_path / "cc.wav"
    control_channel_wav(src)
    out = {}
    for name, mod in (("ref", jcli), ("port", tcli)):
        msgs = tmp_path / f"{name}.json"
        rc, text = run(monkeypatch, capsys, mod, "decode-iq", "--input", str(src), "--messages", str(msgs))
        stats = json.loads(text.split("wrote")[0])
        stats.pop("realtime_x")
        out[name] = (rc, stats, text.split("wrote")[1].split(" to ")[0], json.loads(msgs.read_text()))
    assert out["port"] == out["ref"]
    assert out["port"][1]["tsbk_crc_ok"] >= 75


def test_decode_audio_matches_reference(monkeypatch, capsys, tmp_path):
    rng = np.random.default_rng(18)
    lc240 = p25v.encode_lc_hexbits(p25v.make_group_lc_bits(tgid=2001, source_id=42))
    frames = [pf.build_ldu_frame(0x293, duid, lc240,
                                 imbe_codewords=[rng.integers(0, 2, 144).astype(np.uint8) for _ in range(9)])
              for _ in range(6) for duid in (pf.DUID.LDU1, pf.DUID.LDU2)]
    iq = modulate_c4fm(np.concatenate(frames), 48_000)
    src = tmp_path / "voice.wav"
    write_iq_wav(src, (iq + 0.02 * (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq))))
                 .astype(np.complex64), 48_000)
    out = {}
    for name, mod in (("ref", jcli), ("port", tcli)):
        dst = tmp_path / f"{name}.wav"
        rc, text = run(monkeypatch, capsys, mod, "decode-audio", "--input", str(src), "--output", str(dst))
        written = sorted(p.name for p in tmp_path.glob(f"{name}.*"))
        out[name] = (rc, text.replace(f"{name}.", "X."), written and [w.replace(name, "X") for w in written])
    assert out["port"] == out["ref"]
    assert "frames=12" in out["port"][1] or "frames=11" in out["port"][1], out["port"][1]
    if (tmp_path / "ref.wav").exists():
        (ra, _), (pa, _) = read_audio_wav(tmp_path / "ref.wav"), read_audio_wav(tmp_path / "port.wav")
        assert pa.shape == ra.shape and snr_db(ra, pa) >= 50.0
    else:
        assert (tmp_path / "port.imbe").read_bytes() == (tmp_path / "ref.imbe").read_bytes()


# --- tests/test_cli.py's cases on the port's CLI -------------------------------------------


class TestListAndCapture(ref_cli.TestListAndCapture):
    pass


class TestDemod(ref_cli.TestDemod):
    pass


class TestDecodeIq(ref_cli.TestDecodeIq):
    pass
