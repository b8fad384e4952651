"""PyTorch + CUDA port of :mod:`wavecap_tpu`, for NVIDIA Hopper (sm_90a).

Module for module, this package mirrors the JAX package's layout
(``ops/``, ``models/``, ``capture/``, ``devices/``) and its public names,
so each module here has exactly one counterpart there.  It imports
``torch``, numpy and scipy, and nothing of JAX or of ``wavecap_tpu``.

The server's entry point is the capture engine,
``capture.CaptureManager`` -> ``Capture``: device reads, the host
transport conversion (i16, adaptive i8 / i4, f32), pinned staging and
fetch buffers, a copy stream and event polling around the block program
``capture.pipeline.capture_multi``, and subscriber fan-out.

Entry points that create state take ``device=None`` (``torch_device`` on
``Capture``, whose ``device`` is the SDR), which means the CUDA card:
they raise when there is none unless ``device="cpu"`` is asked for.
Functions that take tensors run where their tensors lie.  The hot
path's kernels (``kernels/csrc/*.cu``) are written by hand for Hopper;
each wrapper launches its kernel on a CUDA tensor and runs the plain
PyTorch version beside it only on a CPU tensor.

Importing the package turns TF32 off for matmuls and cuDNN convolutions:
the reference holds f32-class precision throughout (a 10-bit mantissa
costs tens of dB of DFT and FIR accuracy).
"""

from .utils.torchenv import disable_tf32

__version__ = "0.1.0"

disable_tf32()
