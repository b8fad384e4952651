"""Soft clipping, RMS normalization, RSSI and squelch gating.

Counterpart of ``wavecap_tpu/ops/clip.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_K = np.float32(1.5)
_NORM = np.float32(1.0 / np.tanh(1.5))


def soft_clip(x: torch.Tensor, headroom: float = 0.95) -> torch.Tensor:
    return torch.tanh(x * float(_K)) * float(_NORM * np.float32(headroom))


def rms_normalize(
    x: torch.Tensor, target_rms: float = 0.18, min_rms: float = 1e-4
) -> torch.Tensor:
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    gain = torch.where(
        rms > min_rms, target_rms / rms.clamp_min(min_rms), torch.ones_like(rms)
    )
    return x * gain


def rssi_dbfs(iq: torch.Tensor) -> torch.Tensor:
    """Mean-power RSSI in dBFS over the last axis."""
    p = torch.mean(iq.abs() ** 2, dim=-1)
    return 10.0 * torch.log10(p.clamp_min(1e-20))


def squelch_gate(audio: torch.Tensor, rssi_db: torch.Tensor, threshold_db) -> torch.Tensor:
    """Zero the audio when RSSI is below threshold (open when above)."""
    threshold = torch.as_tensor(threshold_db, dtype=rssi_db.dtype, device=rssi_db.device)
    open_ = rssi_db[..., None] >= threshold[..., None]
    return torch.where(open_, audio, torch.zeros_like(audio))
