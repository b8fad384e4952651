"""Host side of the capture engine (counterpart of
``wavecap_tpu/capture/engine.py``).

So far only the i16 transport's host conversion is ported: device
blocks (complex64) become one int32 word per complex sample, the i16
pair viewed in place, which :func:`..pipeline.capture_step` unpacks on
the card.  The engine's threads, control and fetch loop are ROADMAP
Queue 1 item 9.
"""

from __future__ import annotations

import numpy as np


def pack_i16_words(blocks) -> np.ndarray:
    """Stacked ``(n, N)`` int32 words from ``n`` complex64 blocks: I and Q
    scaled by 32767, rounded, clipped to i16 and viewed as one word."""
    rows = [
        np.clip(
            np.round(np.ascontiguousarray(b).view(np.float32) * 32767.0),
            -32768,
            32767,
        )
        .astype(np.int16)
        .view(np.int32)
        for b in blocks
    ]
    return np.stack(rows)
