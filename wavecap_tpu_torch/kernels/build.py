"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>.so`` (one nvcc per
source, all started together) at first use, and is loaded with
``ctypes``.  The sources include no PyTorch header, so a build takes
seconds; pointers and the stream cross the boundary as ``c_void_p``.
Every C entry returns ``cudaGetLastError()`` right after its launch and
:func:`launch` raises if that is not 0, so a refused launch (too many
threads, too much shared memory) cannot pass silently.

``build/`` is listed in ``.gitignore``: a checkout builds its own.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class K10Coeffs(ctypes.Structure):
    """``K10Coeffs`` of ``csrc/pll_math.cuh``, passed by value; the values
    are ``ops/pll.py``'s ``K10_*`` constants."""

    _fields_ = [("two_over_pi", _F), ("pio2", _F * 3), ("sin", _F * 3), ("cos", _F * 3),
                ("atan", _F * 8), ("atan_pio2", _F), ("fast_max", _F)]


# kernel name -> (source stem, C symbol, argtypes); the last argument of
# every entry is the CUDA stream
KERNELS: dict[str, tuple[str, str, tuple]] = {
    "K1_unpack_arms": (
        "unpack_arms", "k1_unpack_arms", (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    ),
    "K2_arm_dft": ("arm_dft", "k2_arm_dft", (_P, _P, _P) + (_I,) * 7 + (_P,)),
    "K3_slot_frontend": (
        "slot_frontend", "k3_slot_frontend",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    ),
    "K4_voice_fir": (
        "voice_fir", "k4_voice_fir",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    ),
    "K5_resample_poly": (
        "resample_poly", "k5_resample_poly",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _P),
    ),
    "K7_strided_fir": (
        "strided_fir", "k7_strided_fir",
        (_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    ),
    "K9_iir_cascade": (
        "iir_cascade", "k9_iir_cascade", (_P,) * 6 + (_I,) * 7 + (_P,),
    ),
    "K10_pll": ("pll", "k10_pll", (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, K10Coeffs, _P)),
    "K11a_noise_blanker": (
        "noise_blanker", "k11a_noise_blanker", (_P, _P, _P, _I, _I, _I, _F) + (_I,) * 10 + (_P,),
    ),
    "K11b_nr_frames": (
        "noise_reduction", "k11b_nr_frames", (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    ),
    "K11b_nr_gain": ("noise_reduction", "k11b_nr_gain", (_P, _I, _I, _I, _F, _F, _I, _I, _I, _P)),
    "K11b_nr_overlap_add": (
        "noise_reduction", "k11b_nr_overlap_add", (_P,) * 5 + (_I,) * 6 + (_P,),
    ),
    "K12_c4fm_timing": (
        "p25_timing", "k12_c4fm_timing", (_P,) * 6 + (_I,) * 3 + (_F,) * 8 + (_I,) * 4 + (_P,),
    ),
    "K13_cqpsk_timing": (
        "p25_timing", "k13_cqpsk_timing", (_P,) * 6 + (_I,) * 3 + (_F,) * 8 + (_I,) * 4 + (_P,),
    ),
    "K12s_c4fm_scan": ("p25_scan", "k12s_c4fm_scan", (_P,) * 6 + (_I,) * 10 + (_F,) * 10 + (_P,)),
    "K13s_cqpsk_scan": ("p25_scan", "k13s_cqpsk_scan", (_P,) * 6 + (_I,) * 10 + (_F,) * 10 + (_P,)),
    "K13_cfo_power": ("cfo_lines", "k13_cfo_power", (_P, _I, _I, _I, _P, _P)),
    "K13_cfo_lines": ("cfo_lines", "k13_cfo_lines", (_P,) + (_I,) * 15 + (_F, _P, _P, _P)),
    "K14_echo_fit": (
        "echo_fit", "k14_echo_fit",
        (_P, _I, _I, _I, _P, _P, _I) + (_P,) * 8 + (_I, _F, _F, _F, _F, _I, _P),
    ),
}

_LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[str, tuple] = {}
# the capture engine launches from its reader thread while a warmup or
# another capture may build or launch from theirs
_LOCK = threading.Lock()


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list[str]:
    """The one compile line of every kernel: Hopper's sm_90a, full IEEE
    math (no ``--use_fast_math``: the parity with the reference rests on
    IEEE division and accurate ``cosf``/``sinf``/``tanhf``/``log10f``)."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas=-v", "-o", str(output), str(source),
    ]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}.so"


def _stale(stem: str) -> bool:
    lib = _library_path(stem)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build_all() -> dict[str, str]:
    """Compile every stale source in parallel; return ptxas' report per
    source (registers, shared memory, spills) for the ones compiled."""
    stems = sorted({stem for stem, _, _ in KERNELS.values()})
    todo = [s for s in stems if _stale(s)]
    if not todo:
        return {}
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{stem}.", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = nvcc_command(CSRC / f"{stem}.cu", Path(tmp), nvcc)
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[stem] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{stem}.cu:\n{out}")
        else:
            os.replace(tmp, _library_path(stem))  # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _function(name: str):
    """``(c function, its library)`` of kernel ``name``, built and loaded
    at first use."""
    if name in _FUNCTIONS:
        return _FUNCTIONS[name]
    with _LOCK:
        if name in _FUNCTIONS:
            return _FUNCTIONS[name]
        stem, symbol, argtypes = KERNELS[name]
        lib = _LIBS.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_library_path(stem)))
            lib.wavecap_error_string.argtypes = (_I,)
            lib.wavecap_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _FUNCTIONS[name] = (fn, lib)
        return fn, lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; count it.

    Tensors are passed as their data pointers; the caller has checked
    device, dtype, shape and contiguity and keeps them alive.
    """
    fn, lib = _function(name)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*c_args, stream)
    if status != 0:
        raise RuntimeError(
            f"{name} failed to launch: {lib.wavecap_error_string(status).decode()}"
        )
    with _LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
