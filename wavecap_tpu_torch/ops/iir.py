"""IIR filtering: one-pole recurrences and biquad (SOS) cascades.

Counterpart of ``wavecap_tpu/ops/iir.py``.  Every filter takes and
returns its carry state, so a stream continues exactly across blocks:
``(n_sections, 2)`` DF2T states per row for a cascade, the last output
for a one-pole.

The plain versions keep the reference's formulation: each sample is an
affine map of the state (scalar for a one-pole, 2x2 for a biquad), and
the maps are prefix-composed, here by a log-step doubling scan in f32.
On the card, kernel K9 (``kernels/csrc/iir_cascade.cu``) runs a chunked
scan instead: every chunk of a row walks its samples in order through
all sections of a cascade in registers (scipy ``sosfilt``'s DF2T form),
and the chunks' states are joined by a scan with powers of the
recurrence's matrix, built here in float64; the two orders round
differently, which the tests bound against float64 scipy.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy import signal as _sps

from ..kernels import launch
from ..utils.torchenv import DeviceLike, resolve_device

_K9_SOS, _K9_ONEPOLE, _K9_ENVELOPE = 0, 1, 2
K9_MAX_SECTIONS = 8  # sections K9 keeps in registers per launch


# --- the doubling scan (plain versions) ---------------------------------------


def _prefix_scalar(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix composition of the maps ``y -> a[n] y + b[n]`` over
    the last axis: returns ``(A, B)`` with ``y[n] = A[n] y[-1] + B[n]``."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a_l, b_l = a[..., :-d], b[..., :-d]
        a_r, b_r = a[..., d:], b[..., d:]
        a = torch.cat([a[..., :d], a_r * a_l], dim=-1)
        b = torch.cat([b[..., :d], a_r * b_l + b_r], dim=-1)
        d *= 2
    return a, b


def _prefix_affine2(m: torch.Tensor, v: torch.Tensor):
    """Inclusive prefix composition of the maps ``s -> M[n] s + v[n]``
    (``M`` of shape ``(..., n, 2, 2)``, ``v`` of ``(..., n, 2)``) over the
    sample axis."""
    n = m.shape[-3]
    d = 1
    while d < n:
        m_l, v_l = m[..., :-d, :, :], v[..., :-d, :]
        m_r, v_r = m[..., d:, :, :], v[..., d:, :]
        m = torch.cat([m[..., :d, :, :], m_r @ m_l], dim=-3)
        v = torch.cat([v[..., :d, :], (m_r @ v_l[..., None])[..., 0] + v_r], dim=-2)
        d *= 2
    return m, v


# --- one-pole:  y[n] = b0 x[n] + a y[n-1] ------------------------------------


def onepole_init(dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=resolve_device(device))


def onepole_filter_plain(x: torch.Tensor, b0: float, a: float, y_prev: torch.Tensor):
    """Plain version of K9's one-pole mode: the doubling scan."""
    a_t = torch.full_like(x, float(np.float32(a)))
    bx = float(np.float32(b0)) * x
    ap, bp = _prefix_scalar(a_t, bx)
    y = ap * y_prev.to(x.dtype)[..., None] + bp
    return y, y[..., -1]


def _rows(x: torch.Tensor) -> tuple[int, int]:
    n = x.shape[-1]
    return (x.numel() // n if n else 0), n


def _check_k9_input(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"K9 filters float32 rows, not {x.dtype}")


@lru_cache(maxsize=256)
def _k9_coeffs(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


# --- K9's chunked scan: the host-side tables ------------------------------------
#
# Each mode is a linear recurrence in its state, s[n] = A s[n-1] + B u[n],
# with coefficients fixed for a launch.  K9 cuts a row into chunks of L
# samples, one thread each: pass 1 runs every chunk from a zero state
# (the first from the row's carry), pass 2 scans the chunks' end states
# with the powers A^(L 2^j) (a Kogge-Stone scan over the threads), pass 3
# reruns every chunk from its true start state and writes y.

K9_THREADS = 256  # chunks per segment, one thread each (kernels/csrc/iir_cascade.cu)
K9_SEGMENT = 12_288  # samples of a row staged in shared memory at once


def k9_state_size(mode: int, n_sec: int) -> int:
    """The dimension of K9's state vector in ``mode``."""
    return 2 * n_sec if mode == _K9_SOS else (1 if mode == _K9_ONEPOLE else 2)


def k9_step(s: np.ndarray, v, coeffs: tuple, mode: int, n_sec: int):
    """One sample of K9's recurrence in float64, in the kernel's order:
    ``(s', y)`` for the state ``s`` (``(..., D)``) and the input ``v``.
    The state is ``(z1, z2)`` per section for a cascade, the last output
    for a one-pole and ``(attack, release)`` for the envelope."""
    s = np.array(s, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    c = coeffs
    if mode == _K9_SOS:
        for i in range(n_sec):
            b0, b1, b2, a1, a2 = c[5 * i : 5 * i + 5]
            z1, z2 = s[..., 2 * i].copy(), s[..., 2 * i + 1].copy()
            out = b0 * v + z1
            s[..., 2 * i] = -a1 * out + (b1 * v + z2)
            s[..., 2 * i + 1] = -a2 * out + b2 * v
            v = out
        return s, v
    if mode == _K9_ONEPOLE:
        s[..., 0] = c[1] * s[..., 0] + c[0] * v
        return s, s[..., 0]
    s[..., 0] = c[1] * s[..., 0] + c[0] * np.abs(v)
    s[..., 1] = c[3] * s[..., 1] + c[2] * s[..., 0]
    return s, np.maximum(s[..., 0], s[..., 1])


@lru_cache(maxsize=256)
def k9_state_matrix(coeffs: tuple, mode: int, n_sec: int) -> np.ndarray:
    """``A`` of K9's recurrence in float64: the step applied to each basis
    state with a zero input (the input term and the output's ``|x|`` and
    ``max`` leave it alone)."""
    d = k9_state_size(mode, n_sec)
    return np.stack([k9_step(e, 0.0, coeffs, mode, n_sec)[0] for e in np.eye(d)], axis=1)


def k9_scan_matrices(coeffs: tuple, mode: int, n_sec: int, chunk: int, levels: int) -> np.ndarray:
    """``(levels, D, D)`` float64: ``A^(chunk 2^j)`` for the scan's steps,
    by repeated squaring of ``A^chunk``."""
    a = k9_state_matrix(coeffs, mode, n_sec)
    p = np.linalg.matrix_power(a, chunk)
    out = []
    for _ in range(levels):
        out.append(p)
        p = p @ p
    return np.stack(out) if out else np.zeros((0,) + a.shape)


def k9_plan(n: int) -> tuple[int, int]:
    """``(chunk, segment)`` of K9 for rows of ``n`` samples: a row runs in
    segments of at most ``K9_SEGMENT`` samples, each cut into at most
    ``K9_THREADS`` chunks of an odd length (a thread's reads of shared
    memory then fall in distinct banks)."""
    n_seg = -(-n // K9_SEGMENT)
    segment = -(-n // n_seg)
    return -(-segment // K9_THREADS) | 1, segment


@lru_cache(maxsize=256)
def _k9_scan_tables(coeffs: tuple, mode: int, n_sec: int, chunk: int, levels: int,
                    device: torch.device) -> torch.Tensor:
    mats = k9_scan_matrices(coeffs, mode, n_sec, chunk, levels).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(mats)).to(device)


def _k9(x: torch.Tensor, coeffs: tuple, state: torch.Tensor, mode: int, n_sec: int):
    """Launch K9 over the rows of ``x``; ``state`` is the per-row carry in
    K9's layout (already broadcast to the rows).  Returns ``(y, state)``."""
    _check_k9_input(x)
    rows, n = _rows(x)
    chunk, segment = k9_plan(n)
    levels = (-(-segment // chunk) - 1).bit_length()
    xc = x.contiguous()
    z0 = state.to(torch.float32).contiguous()
    y = torch.empty_like(xc)
    z1 = torch.empty_like(z0)
    tables = _k9_scan_tables(coeffs, mode, n_sec, chunk, levels, x.device)
    launch("K9_iir_cascade", x.device, xc, y, _k9_coeffs(coeffs, x.device), z0, z1, tables,
           rows, n, n_sec, mode, chunk, segment, levels)
    return y, z1


def onepole_filter(x: torch.Tensor, b0: float, a: float, y_prev: torch.Tensor):
    """Streaming one-pole IIR over the last axis.  Returns ``(y, y_last)``.

    ``y_prev`` is a scalar or of the batch shape of ``x``.  On a CUDA
    tensor this launches K9; only a CPU tensor takes the plain scan."""
    if x.shape[-1] == 0:
        return x, y_prev
    if x.device.type == "cpu":
        return onepole_filter_plain(x, b0, a, y_prev)
    lead = x.shape[:-1]
    state = y_prev.to(torch.float32).expand(lead).reshape(-1)
    coeffs = (float(np.float32(b0)), float(np.float32(a)))
    y, last = _k9(x, coeffs, state, _K9_ONEPOLE, 1)
    return y, last.reshape(lead)


def deemphasis_coeffs(sample_rate: float, tau: float = 75e-6):
    """FM deemphasis one-pole, impulse-invariant: ``(b0, a)`` with the
    -3 dB point at ``1/(2 pi tau)`` (the reference's textbook pole)."""
    a = float(np.exp(-1.0 / (tau * sample_rate)))
    return 1.0 - a, a


def deemphasis(x: torch.Tensor, sample_rate: float, tau: float, y_prev: torch.Tensor):
    b0, a = deemphasis_coeffs(sample_rate, tau)
    return onepole_filter(x, b0, a, y_prev)


# --- biquad cascade (SOS) -------------------------------------------------------


def sos_init(n_sections: int, dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Per-section DF2T state ``z = (z1, z2)``."""
    return torch.zeros((n_sections, 2), dtype=dtype, device=resolve_device(device))


def _biquad_scan(x: torch.Tensor, b0: float, b1: float, b2: float, a1: float, a2: float,
                 z0: torch.Tensor):
    """One DF2T biquad as a prefix scan of 2x2 affine maps (plain version).

    State ``s = (z1, z2)``: ``s[n] = A s[n-1] + B x[n]`` with
    ``A = [[-a1, 1], [-a2, 0]]``, ``B = (b1 - a1 b0, b2 - a2 b0)`` and
    ``y[n] = b0 x[n] + z1[n-1]``, the f32 casts placed as the reference's.
    """
    dev = x.device
    a_mat = torch.tensor([[-a1, 1.0], [-a2, 0.0]], dtype=torch.float32, device=dev)
    bv = torch.tensor([b1 - a1 * b0, b2 - a2 * b0], dtype=torch.float32, device=dev)
    n = x.shape[-1]
    m = a_mat.expand(x.shape[:-1] + (n, 2, 2))
    v = x[..., None] * bv
    mp, vp = _prefix_affine2(m, v)
    z0 = z0.to(torch.float32).expand(x.shape[:-1] + (2,))
    s = (mp @ z0[..., None, :, None])[..., 0] + vp
    s_prev = torch.cat([z0[..., None, :], s[..., :-1, :]], dim=-2)
    y = float(np.float32(b0)) * x + s_prev[..., 0]
    return y, s[..., -1, :]


def sos_filter_plain(x: torch.Tensor, sos: np.ndarray, z: torch.Tensor):
    """Plain version of K9's cascade mode: one doubling scan per section."""
    zs = []
    y = x
    for i in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(v) for v in sos[i])
        y, zi = _biquad_scan(y, b0, b1, b2, a1, a2, z[..., i, :])
        zs.append(zi)
    return y, torch.stack(zs, dim=-2)


def sos_filter(x: torch.Tensor, sos: np.ndarray, z: torch.Tensor):
    """Cascade of biquads (scipy ``sosfilt`` semantics) over the last axis.
    Returns ``(y, z)``; ``z`` is ``(n_sections, 2)`` or of the batch shape
    of ``x`` plus that.  On a CUDA tensor this launches K9 once for the
    whole cascade; only a CPU tensor takes the plain scan."""
    if x.shape[-1] == 0:  # empty block: state passes through unchanged
        return x, z
    if x.device.type == "cpu":
        return sos_filter_plain(x, sos, z)
    n_sec = int(sos.shape[0])
    if n_sec > K9_MAX_SECTIONS:
        raise NotImplementedError(f"K9 runs cascades of up to {K9_MAX_SECTIONS} sections")
    lead = x.shape[:-1]
    state = z.to(torch.float32).expand(lead + (n_sec, 2)).reshape(-1, n_sec, 2)
    coeffs = tuple(float(np.float32(sos[i, j])) for i in range(n_sec) for j in (0, 1, 2, 4, 5))
    y, z1 = _k9(x, coeffs, state, _K9_SOS, n_sec)
    return y, z1.reshape(lead + (n_sec, 2))


# --- designs (host side, cached) ------------------------------------------------


@lru_cache(maxsize=128)
def butter_sos(btype: str, cutoff: tuple, order: int, sample_rate: float) -> np.ndarray:
    wn = [c / (sample_rate / 2.0) for c in cutoff]
    return _sps.butter(
        order, wn if len(wn) > 1 else wn[0], btype=btype, output="sos"
    ).astype(np.float64)


@lru_cache(maxsize=64)
def notch_sos(freq_hz: float, q: float, sample_rate: float) -> np.ndarray:
    b, a = _sps.iirnotch(freq_hz / (sample_rate / 2.0), q)
    return _sps.tf2sos(b, a).astype(np.float64)


def lowpass(x, sample_rate, cutoff, z, order=5):
    return sos_filter(x, butter_sos("low", (float(cutoff),), order, float(sample_rate)), z)


def highpass(x, sample_rate, cutoff, z, order=5):
    return sos_filter(x, butter_sos("high", (float(cutoff),), order, float(sample_rate)), z)


def bandpass(x, sample_rate, low, high, z, order=4):
    sos = butter_sos("band", (float(low), float(high)), order, float(sample_rate))
    return sos_filter(x, sos, z)


def notch(x, sample_rate, freq_hz, z, q=30.0):
    return sos_filter(x, notch_sos(float(freq_hz), float(q), float(sample_rate)), z)


def n_sections(btype: str, order: int) -> int:
    """Number of SOS sections scipy produces for this design."""
    if btype == "band":
        return order  # bandpass doubles the order
    return (order + 1) // 2
