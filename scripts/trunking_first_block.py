"""Why a trunking capture's first block differs between the card and the CPU.

Runs on the CPU (no card): program I1's scene (``chip_smoke.i1_scene``,
2.4 Msps, i8 words) through the port's engine twice from the same zero
state, once with the plain K2 (torch's matmul DFT) and once with K2's
arithmetic emulated on the host (its tables in the kernel's layout, the
products split into 3xTF32 as the kernel forms them), and prints the
C4FM soft symbols' SNR between the two a block, the K12 input rows' (the
demodulated rows') SNR a block, and where in the first block that input
differs most::

    python3 scripts/trunking_first_block.py [--blocks 4]
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from wavecap_tpu_torch.models.p25 import c4fm  # noqa: E402
from wavecap_tpu_torch.ops import channelizer as chz  # noqa: E402


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def k2_emulated(u: torch.Tensor, cfg) -> torch.Tensor:
    """K2 on the host in the kernel's layout with its 3xTF32 products (as
    ``tests/test_torch_channelizer.py:k2_emulated``)."""
    u = u.numpy()
    m = cfg.channel_count
    m1, m2, k1p, n1s, k2p, n2s = chz._k2_layout(m)
    tab = chz.k2_tables_np(m)
    b1 = tab[: 2 * k1p * n1s].reshape(k1p, n1s, 2)[:, :k1p]
    tab = tab[2 * k1p * n1s:]
    b2 = tab[: 2 * k2p * n2s].reshape(k2p, n2s, 2)[:, :k2p]
    tab = tab[2 * k2p * n2s:]
    tw = tab[: 2 * m].reshape(m1, m2, 2)
    ch = tab[2 * m:].view(np.complex64)

    def gemm(a, b):
        ah, al = chz.tf32_split(a)
        bh, bl = b[..., 0], b[..., 1]
        f = lambda p, q: p.astype(np.float64) @ q.astype(np.float64)  # noqa: E731
        return (f(tf32_trunc(al), bh) + f(ah, tf32_trunc(bl)) + f(ah, bh)).astype(np.float32)

    s = 2 * u.shape[1]
    x = np.stack([u[0], u[1]], axis=1).reshape(s, m1, m2)
    x1 = np.zeros((s, m2, k1p), np.float32)
    x1[:, :, 0: 2 * m1: 2] = x.real.transpose(0, 2, 1)
    x1[:, :, 1: 2 * m1: 2] = x.imag.transpose(0, 2, 1)
    a = gemm(x1, b1)
    a = (a[..., 0: 2 * m1: 2] + 1j * a[..., 1: 2 * m1: 2]).transpose(0, 2, 1)
    bt = (a * (tw[..., 0] + 1j * tw[..., 1])).astype(np.complex64)
    x2 = np.zeros((s, m1, k2p), np.float32)
    x2[..., 0: 2 * m2: 2], x2[..., 1: 2 * m2: 2] = bt.real, bt.imag
    y = gemm(x2, b2)
    y = y[..., 0: 2 * m2: 2] + 1j * y[..., 1: 2 * m2: 2]
    y = y.transpose(0, 2, 1).reshape(s, m) * ch
    odd = (np.arange(s) % 2 == 1)[:, None] & (np.arange(m) % 2 == 1)[None, :]
    return torch.from_numpy(np.where(odd, -y, y).T.astype(np.complex64))


def run(blocks: list, k2) -> tuple:
    """The blocks through I1's system on the CPU with ``k2`` as K2's plain
    version; the control slot's soft symbols a block and K12's input rows."""
    plain, timing = chz.arm_dft_plain, c4fm.c4fm_timing_plain
    rows, soft = [], []

    def tapped(buf, st, n_sym, cfg):
        rows.append(buf[0].clone())
        out = timing(buf, st, n_sym, cfg)
        soft.append(out[0][0].clone())
        return out

    chz.arm_dft_plain, c4fm.c4fm_timing_plain = k2, tapped
    tmp = tempfile.mkdtemp()
    try:
        with c.i_clock() as clock:
            s = c.i_system(c.i_config("first", os.path.join(tmp, "rec")), "cpu", os.path.join(tmp, "state"))
            c.i_start(s)
            try:
                c.i_drive(s, blocks, clock)
            finally:
                c.i_stop(s)
    finally:
        chz.arm_dft_plain, c4fm.c4fm_timing_plain = plain, timing
    return [x.numpy() for x in soft], [x.numpy() for x in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    x, _, _ = c.i1_scene(c.I1_BLOCKS, c.I_BLOCK)
    blocks = c.i_blocks(x, args.blocks, c.I_BLOCK)
    soft_p, rows_p = run(blocks, chz.arm_dft_plain)
    soft_k, rows_k = run(blocks, k2_emulated)
    print("soft SNR a block, emulated K2 against the plain K2 (dB):",
          [round(c.snr_db(a, b), 2) for a, b in zip(soft_p, soft_k)])
    print("K12 input rows' SNR a block (dB):", [round(c.snr_db(a, b), 1) for a, b in zip(rows_p, rows_k)])
    d = np.abs(rows_p[0] - rows_k[0])
    top = np.sort(np.argsort(d)[::-1][:12])
    print("first block: the largest differences of K12's input at samples", top.tolist(),
          f"(of {len(d)}; the first 64 are the interpolation tail), up to {d.max():.3f} against a mean |x| of "
          f"{np.abs(rows_p[0]).mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
