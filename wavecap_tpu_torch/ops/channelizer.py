"""Non-maximally-decimated polyphase filter-bank channelizer (NMDPFB).

Counterpart of ``wavecap_tpu/ops/channelizer.py``: one wideband block
becomes M channels, each 2x oversampled (rate ``2 fs / M``), with the
standard Fred Harris M/2 scheme.  Even and odd output steps come from
two polyphase stacks,

    u[r, c] = sum_{k<T} arms_rev[k, c] * x_ext[off + (r + T-1-k) M + c],

(``off`` = 1 for even steps, 1 + M/2 for odd), then a forward DFT across
the arms, a twiddle ``e^{-2 pi i c / M}``, the ``(-1)^c`` sign on odd
steps, and the interleave and transpose to ``(M, S)``.

Two kernels carry it on the card, each with its plain version here:

* K1 ``unpack_arms``: the packed transport words (i16 pairs in int32
  words; the adaptive i8 pairs in int16 and i4 nibble pairs in int8
  words, with the block's f32 scale on the card) or complex samples, and
  the history in, both parity stacks (and the unpacked block) out;
* K2 ``arm_dft``: the factored matmul DFT across arms with the twiddle,
  sign, interleave and transpose.

For a power-of-two M, ``dft_impl="auto"`` takes ``torch.fft.fft``, as
the reference takes XLA's FFT there.  Streaming state is the last
``M*T`` input samples; the block length must be a multiple of ``M``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps

from ..kernels import launch
from ..utils.torchenv import DeviceLike, resolve_device

_SMEM_LIMIT = 232_448  # bytes of shared memory a block can have on Hopper


@lru_cache(maxsize=32)
def design_prototype(
    channel_count: int, taps_per_channel: int, cutoff_scale: float = 0.5, beta: float = 8.0
) -> np.ndarray:
    """Kaiser lowpass prototype, unity DC gain, length ``M*T`` (zero-padded)."""
    m, t = channel_count, taps_per_channel
    cutoff = 2.0 * cutoff_scale / m  # normalized to Nyquist
    h = _sps.firwin(m * t - 1, cutoff, window=("kaiser", beta))
    return np.concatenate([h, [0.0]]).astype(np.float32)


@dataclass(frozen=True)
class ChannelizerConfig:
    sample_rate: float
    channel_bandwidth: float = 25_000.0
    taps_per_channel: int = 9
    cutoff_scale: float = 0.5
    # Cross-arm DFT: "fft" (torch.fft), "matmul" (the factored matmul DFT,
    # kernel K2 on the card), or "auto" (matmul for non-power-of-2 M <= 2048)
    dft_impl: str = "auto"

    def _use_matmul_dft(self) -> bool:
        if self.dft_impl == "matmul":
            return True
        if self.dft_impl == "fft":
            return False
        m = self.channel_count
        return m <= 2048 and (m & (m - 1)) != 0

    @property
    def channel_count(self) -> int:
        m = int(self.sample_rate / self.channel_bandwidth)
        return m - (m % 2)

    @property
    def channel_rate(self) -> float:
        """Per-channel output rate (2x oversampled)."""
        return 2.0 * self.sample_rate / self.channel_count

    def channel_index(self, offset_hz: float) -> int:
        """FFT-bin channel index for a frequency offset from band center."""
        m = self.channel_count
        idx = int(round(offset_hz / (self.sample_rate / m)))
        return idx % m

    def channel_offset_hz(self, index: int) -> float:
        m = self.channel_count
        if index >= m // 2:
            index -= m
        return index * self.sample_rate / m


def channelizer_init(cfg: ChannelizerConfig, device: DeviceLike = None) -> torch.Tensor:
    """History carry: last ``M*T`` input samples (zeros at stream start)."""
    n = cfg.channel_count * cfg.taps_per_channel
    return torch.zeros(n, dtype=torch.complex64, device=resolve_device(device))


# --- host-built tables, cached per device -----------------------------------


@lru_cache(maxsize=32)
def _arms_rev(m: int, t: int, cutoff_scale: float, device: torch.device) -> torch.Tensor:
    # column-reversed arms fold the per-window sample reversal into the taps
    proto = design_prototype(m, t, cutoff_scale)
    return torch.from_numpy(proto.reshape(t, m)[:, ::-1].copy()).to(device)


def _twiddle_np(m: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)


@lru_cache(maxsize=32)
def _epilogue_tables(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    sign = np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return torch.from_numpy(_twiddle_np(m)).to(device), torch.from_numpy(sign).to(device)


def _k2_factors(m: int) -> tuple[int, int]:
    """(m1, m2) of K2's two stages; an unfactorable m runs as 1 x m, which
    is the single matmul DFT of ``planar_matmul_dft``."""
    from .planar import _dft_factor  # planar imports this module

    return _dft_factor(m) or (1, m)


def _stride_mod(n: int, r: int, q: int = 32) -> int:
    """The least stride >= n that is r mod q (rows in distinct banks)."""
    return n + (r - n) % q


def _k2_layout(m: int) -> tuple[int, int, int, int, int, int]:
    """``(m1, m2, k1p, n1s, k2p, n2s)`` of K2's tables: stage ``i``'s real
    (2 mi x 2 mi) table padded to ``kip`` (a multiple of 8) rows and
    columns of (hi, lo) pairs, rows ``nis`` pairs apart (4 mod 16)."""
    m1, m2 = _k2_factors(m)
    k1p, k2p = -(-2 * m1 // 8) * 8, -(-2 * m2 // 8) * 8
    return m1, m2, k1p, _stride_mod(k1p, 4, 16), k2p, _stride_mod(k2p, 4, 16)


def _k2_smem_bytes(m: int) -> int:
    """The least shared memory a K2 block runs with (kernels/csrc/arm_dft.cu
    make_layout): two input buffers of 1 step and its stage-2 rows, the
    tables read from device memory.  The kernel takes tiles of 2 or 4
    steps and the tables into shared memory where those fit."""
    m1, m2, _, _, k2p, _ = _k2_layout(m)
    xsz = max(m1 * _stride_mod(2 * m2, 16, 32), 2 * (m + 4))
    return 4 * (2 * xsz + m1 * _stride_mod(k2p, 4, 32))


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 ``x = hi + lo`` exactly: ``hi`` rounded to TF32's 10 mantissa
    bits, to nearest with ties away from zero (``cvt.rna.tf32.f32``), and
    ``lo`` the f32 remainder, of which the tensor cores read 10 bits."""
    x = np.asarray(x, np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, (x - hi).astype(np.float32)


def _real_form(c: np.ndarray, s: np.ndarray, rows: int, stride: int) -> np.ndarray:
    """The real (2k x 2n) form of the complex table ``c + i s`` on
    interleaved (re, im) rows and columns, zero-padded to ``rows`` x
    ``stride``: ``[x_re, x_im] @ [[c, s], [-s, c]] = [y_re, y_im]``."""
    k, n = c.shape
    out = np.zeros((rows, stride), np.float32)
    out[0 : 2 * k : 2, 0 : 2 * n : 2] = c
    out[1 : 2 * k : 2, 0 : 2 * n : 2] = -s
    out[0 : 2 * k : 2, 1 : 2 * n : 2] = s
    out[1 : 2 * k : 2, 1 : 2 * n : 2] = c
    return out


def k2_stage_mats(m: int):
    """``((c1, s1), (c2, s2), (twc, tws))``: the f32 (cos, sin) planes of
    K2's two stages and its stage twiddle, the plain version's tables; an
    unfactorable ``m`` runs as 1 x m."""
    from .planar import _dft_factor, _factored_mats, dft_matrices

    if _dft_factor(m) is not None:
        return _factored_mats(m, False)
    one, zero = np.ones((1, 1), np.float32), np.zeros((1, 1), np.float32)
    return ((one, zero), dft_matrices(m, False),
            (np.ones((1, m), np.float32), np.zeros((1, m), np.float32)))


def k2_tables_np(m: int) -> np.ndarray:
    """K2's tables in one f32 buffer, in the kernel's layout: W1 and W2 in
    their real forms (:func:`_real_form`) as (hi, lo) pairs
    (:func:`tf32_split`), the stage twiddle as (cos, sin) pairs ``(m1, m2,
    2)``, then the channel twiddle as (re, im) pairs.  The entries are the
    plain version's f32 tables."""
    m1, m2, k1p, n1s, k2p, n2s = _k2_layout(m)
    (c1, s1), (c2, s2), (twc, tws) = k2_stage_mats(m)
    parts = [np.stack(tf32_split(_real_form(c1, s1, k1p, n1s)), axis=-1).ravel(),
             np.stack(tf32_split(_real_form(c2, s2, k2p, n2s)), axis=-1).ravel(),
             np.stack([twc, tws], axis=-1).ravel(), _twiddle_np(m).view(np.float32)]
    return np.concatenate(parts)


@lru_cache(maxsize=32)
def _k2_tables(m: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(k2_tables_np(m)).to(device)


# --- K1: unpack + polyphase arms ---------------------------------------------


def _unpack_i16_words(words: torch.Tensor) -> torch.Tensor:
    """i16 pairs in int32 words -> complex64 scaled 1/32768 (low half I).

    The low half is sign-extended by masking: a left shift of a signed
    int32 is not guaranteed to wrap in torch."""
    lo = ((words & 0xFFFF) ^ 0x8000) - 0x8000
    hi = words >> 16
    s = 1.0 / 32768.0
    return torch.complex(lo.to(torch.float32) * s, hi.to(torch.float32) * s)


def _unpack_i8_words(words: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Adaptive-i8 pairs in int16 words (low byte I) -> complex64 times the
    block's f32 ``scale`` (a tensor, so the card never hands it back)."""
    lo = ((words & 0xFF) ^ 0x80) - 0x80
    hi = words >> 8
    return torch.complex(lo.to(torch.float32) * scale, hi.to(torch.float32) * scale)


def _unpack_i4_words(words: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Adaptive-i4 nibble pairs in int8 words (low nibble I) -> complex64
    times the block's f32 ``scale``."""
    lo = ((words & 0xF) ^ 0x8) - 0x8
    hi = words >> 4
    return torch.complex(lo.to(torch.float32) * scale, hi.to(torch.float32) * scale)


# word dtype -> K1's source kind (0 is complex64 samples)
_WORD_KINDS = {torch.int32: 1, torch.int16: 2, torch.int8: 3}


def unpack_words(words: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """Transport words -> complex64: int32 i16 pairs, or int16 / int8
    adaptive words with their block ``scale``."""
    if words.dtype == torch.int32:
        return _unpack_i16_words(words)
    if scale is None:
        raise ValueError(f"{words.dtype} transport words carry a scale")
    if words.dtype == torch.int16:
        return _unpack_i8_words(words, scale)
    return _unpack_i4_words(words, scale)


def _check_block(x: torch.Tensor, hist: torch.Tensor, m: int, t: int, scale) -> None:
    if x.dim() != 1 or x.shape[0] % m != 0:
        raise ValueError(f"block must be 1-D with a length that is a multiple of M={m}")
    if x.dtype not in (torch.complex64, *_WORD_KINDS):
        raise TypeError(f"block must be transport words (int32, int16, int8) or complex64, not {x.dtype}")
    if x.dtype in (torch.int16, torch.int8):
        if scale is None or scale.dtype != torch.float32 or scale.numel() != 1:
            raise ValueError(f"{x.dtype} words need their block scale as one float32 element")
        if scale.device != x.device:
            raise ValueError("block and scale lie on different devices")
    if hist.shape != (m * t,) or hist.dtype != torch.complex64:
        raise ValueError(f"history must be complex64 of shape ({m * t},)")
    if hist.device != x.device:
        raise ValueError("block and history lie on different devices")


_K1_THREADS = 256  # threads a K1 CTA
_K1_ROWS = (2, 4, 8, 16)  # rows a tile that K1 is built for
_K1_PLAN_ROWS = 4  # the rows a tile K1 runs: the fastest at every path's shape (PERF.md)


class K1Plan(NamedTuple):
    """How K1 runs: one thread a (tile of ``rows`` rows, position column)
    pair, the column fastest, ``threads`` a CTA, ``ctas`` CTAs; a thread
    holds the ``window = rows + T`` samples of its column and its ``2 T``
    arm taps in registers (the kernel uses no shared memory)."""

    rows: int
    threads: int
    ctas: int
    window: int


def k1_plan(m: int, t: int, r_steps: int, kind: int, forced: int | None = None) -> K1Plan:
    """K1's launch plan, the one the kernel runs: 4 rows a tile at every
    shape and word ``kind`` (timed against 2, 8 and 16 by
    ``scripts/k1_k3_variants.py``: larger tiles read fewer halo rows but
    hold more registers and give the card fewer threads).  ``forced``: the
    rows a tile in its place, one of ``_K1_ROWS``."""
    rows = _K1_PLAN_ROWS if forced is None else forced
    if rows not in _K1_ROWS:
        raise ValueError(f"K1 is built for {_K1_ROWS} rows a tile, not {rows}")
    items = m * -(-r_steps // rows)
    return K1Plan(rows, _K1_THREADS, -(-items // _K1_THREADS), rows + t)


def unpack_arms_plain(x: torch.Tensor, hist: torch.Tensor, cfg: ChannelizerConfig,
                      scale: torch.Tensor | None = None):
    """Plain version of K1: ``(x_complex, u)`` with ``u`` of shape
    ``(2, N/M, M)`` complex64 (even stack, odd stack).  ``scale`` is the
    adaptive i8 / i4 block's f32 scale."""
    m, t = cfg.channel_count, cfg.taps_per_channel
    _check_block(x, hist, m, t, scale)
    x_c = x if x.is_complex() else unpack_words(x, scale)
    r_steps = x_c.shape[-1] // m
    arms = _arms_rev(m, t, cfg.cutoff_scale, x_c.device)
    x_ext = torch.cat([hist, x_c])

    def parity_stack(offset: int) -> torch.Tensor:
        w = x_ext[offset : offset + (r_steps + t - 1) * m].reshape(r_steps + t - 1, m)
        u = torch.zeros((r_steps, m), dtype=torch.complex64, device=x_c.device)
        for k in range(t):
            u = u + w[t - 1 - k : t - 1 - k + r_steps] * arms[k]
        return u

    return x_c, torch.stack([parity_stack(1), parity_stack(1 + m // 2)])


def unpack_arms(x: torch.Tensor, hist: torch.Tensor, cfg: ChannelizerConfig,
                scale: torch.Tensor | None = None):
    """K1: ``(x_complex, u)``; see :func:`unpack_arms_plain`.

    On a CUDA tensor this launches the kernel (which also writes the
    unpacked block for word input and reads ``scale`` on the card); only a
    CPU tensor takes the plain version.  An empty block launches nothing."""
    if x.device.type == "cpu":
        return unpack_arms_plain(x, hist, cfg, scale)
    m, t = cfg.channel_count, cfg.taps_per_channel
    _check_block(x, hist, m, t, scale)
    if not (x.is_contiguous() and hist.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    n = x.shape[0]
    r_steps = n // m
    u = torch.empty((2, r_steps, m), dtype=torch.complex64, device=x.device)
    kind = _WORD_KINDS.get(x.dtype, 0)
    x_c = torch.empty(n, dtype=torch.complex64, device=x.device) if kind else x
    if r_steps == 0:  # an empty block (N % M == 0): nothing to launch
        return x_c, u
    arms = _arms_rev(m, t, cfg.cutoff_scale, x.device)
    plan = k1_plan(m, t, r_steps, kind)
    launch(
        "K1_unpack_arms", x.device, x, kind, scale if kind >= 2 else None, hist, arms, u,
        x_c if kind else None, m, t, r_steps, plan.rows, plan.threads,
    )
    return x_c, u


# --- K2: cross-arm DFT + epilogue --------------------------------------------


def _arm_epilogue(y: torch.Tensor, m: int) -> torch.Tensor:
    """DFT'd stacks ``(2, R, M)`` -> channels ``(M, 2R)``: twiddle, the
    odd-step sign, interleave even/odd steps, transpose."""
    tw, sign = _epilogue_tables(m, y.device)
    y = y * tw
    r_steps = y.shape[1]
    inter = torch.stack([y[0], y[1] * sign], dim=1).reshape(2 * r_steps, m)
    return inter.T.contiguous()


def _fft_arms(u: torch.Tensor, cfg: ChannelizerConfig) -> torch.Tensor:
    """The ``dft_impl="fft"`` route: ``torch.fft`` across arms (the
    counterpart of the reference's XLA FFT), then the epilogue."""
    return _arm_epilogue(torch.fft.fft(u, dim=-1) if u.shape[1] else u, cfg.channel_count)


def arm_dft_plain(u: torch.Tensor, cfg: ChannelizerConfig) -> torch.Tensor:
    """Plain version of K2: the matmul DFT across arms (factored where M
    factors, else one matmul), then the epilogue; ``(M, S)`` complex64."""
    from .planar import _dft_factor, planar_factored_dft, planar_matmul_dft

    m = cfg.channel_count
    dft = planar_factored_dft if _dft_factor(m) is not None else planar_matmul_dft
    yr, yi = dft(u.real, u.imag, m, inverse=False)
    return _arm_epilogue(torch.complex(yr, yi), m)


def arm_dft(u: torch.Tensor, cfg: ChannelizerConfig) -> torch.Tensor:
    """K2: channels ``(M, S)`` from the stacks ``(2, R, M)``; see
    :func:`arm_dft_plain`.  Only a CPU tensor takes the plain version; no
    steps (an empty block) launch nothing."""
    if u.device.type == "cpu":
        return arm_dft_plain(u, cfg)
    m = cfg.channel_count
    if u.dim() != 3 or u.shape[0] != 2 or u.shape[2] != m or u.dtype != torch.complex64:
        raise ValueError(f"K2 takes complex64 stacks of shape (2, R, {m})")
    if not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous tensor on a 16-byte boundary")
    if _k2_smem_bytes(m) > _SMEM_LIMIT:
        raise NotImplementedError(f"K2 stages two steps in shared memory; M={m} is too large")
    r_steps = u.shape[1]
    out = torch.empty((m, 2 * r_steps), dtype=torch.complex64, device=u.device)
    if r_steps == 0:
        return out
    m1, m2, k1p, n1s, k2p, n2s = _k2_layout(m)
    launch("K2_arm_dft", u.device, u, _k2_tables(m, u.device), out, m1, m2, r_steps,
           k1p, n1s, k2p, n2s)
    return out


# --- the channelizer ---------------------------------------------------------


def _channelize(x: torch.Tensor, state: torch.Tensor, cfg: ChannelizerConfig,
                scale: torch.Tensor | None = None):
    """``(x_complex, channels, state)`` for complex or transport-word input."""
    m, t = cfg.channel_count, cfg.taps_per_channel
    x_c, u = unpack_arms(x, state, cfg, scale)
    chans = arm_dft(u, cfg) if cfg._use_matmul_dft() else _fft_arms(u, cfg)
    h = m * t
    n = x_c.shape[-1]
    new_state = x_c[n - h :].clone() if n >= h else torch.cat([state, x_c])[-h:]
    return x_c, chans, new_state


def channelize(x: torch.Tensor, state: torch.Tensor, cfg: ChannelizerConfig):
    """Channelize one block.

    Args:
        x: ``(N,)`` complex64 wideband IQ, ``N % M == 0``.
        state: history from :func:`channelizer_init` / previous call.

    Returns:
        ``(channels, state)`` with ``channels`` of shape ``(M, S)``
        complex64, ``S = 2N/M``; channel ``c`` is centered at offset
        ``c*fs/M`` (FFT bin order, negative offsets wrap).
    """
    _, chans, new_state = _channelize(x, state, cfg)
    return chans, new_state
