"""PyTorch + CUDA port of :mod:`wavecap_tpu`, for NVIDIA Hopper (sm_90a).

Module for module, this package mirrors the JAX package's layout
(``ops/``, ``models/``, ``capture/``, ``devices/``) and its public names,
so each module here has exactly one counterpart there.  It imports
``torch``, numpy and scipy, and nothing of JAX or of ``wavecap_tpu``.

Entry points that create state take ``device=None``, which means the
CUDA card: they raise when there is none unless ``device="cpu"`` is asked
for.  Functions that take tensors run where their tensors lie.  The hot
path's kernels (``kernels/csrc/*.cu``) are written by hand for Hopper;
each wrapper launches its kernel on a CUDA tensor and runs the plain
PyTorch version beside it only on a CPU tensor.

Importing the package turns TF32 off for matmuls and cuDNN convolutions:
the reference holds f32-class precision throughout (a 10-bit mantissa
costs tens of dB of DFT and FIR accuracy).
"""

from .utils.torchenv import disable_tf32

disable_tf32()
