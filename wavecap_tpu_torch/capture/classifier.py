"""Channel activity classifier: a copy of ``wavecap_tpu/capture/classifier.py``.

Per-FFT-bin running statistics -> classify occupied bins as control
(steady carrier) vs voice (bursty) channels.  Fed from the capture's
spectrum frames; all statistics are vectorized numpy on the host (the
spectra already came off the device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class ClassifiedChannel:
    frequency_hz: float
    kind: str  # "control" | "voice" | "data"
    occupancy: float  # fraction of frames above threshold
    mean_db: float
    variance_db: float


class ChannelClassifier:
    """Running mean/variance per FFT bin with exponential forgetting."""

    def __init__(
        self,
        center_hz: float,
        sample_rate: float,
        fft_size: int = 2048,
        alpha: float = 0.05,
        floor_offset_db: float = 8.0,
    ):
        self.center_hz = center_hz
        self.sample_rate = sample_rate
        self.fft_size = fft_size
        self.alpha = alpha
        self.floor_offset_db = floor_offset_db
        self.mean = np.full(fft_size, -120.0, np.float32)
        self.var = np.zeros(fft_size, np.float32)
        self.occupancy = np.zeros(fft_size, np.float32)
        self.frames = 0

    def update(self, spectrum_db: np.ndarray) -> None:
        s = np.asarray(spectrum_db, np.float32)
        if s.ndim == 2:
            for row in s:
                self.update(row)
            return
        if self.frames == 0:
            # seed from the first frame: starting the mean at -120 dB
            # poisons the variance EMA with a burn-in transient that takes
            # hundreds of frames to decay
            self.mean = s.copy()
        d = s - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        noise_floor = np.median(self.mean)
        active = s > noise_floor + self.floor_offset_db
        self.occupancy = (1 - self.alpha) * self.occupancy + self.alpha * active
        self.frames += 1

    def classify(
        self, min_occupancy: float = 0.3, merge_bins: int = 3
    ) -> list[ClassifiedChannel]:
        """Group occupied bins into channels and label them."""
        if self.frames < 10:
            return []
        noise_floor = float(np.median(self.mean))
        occupied = np.nonzero(self.occupancy > min_occupancy)[0]
        out: list[ClassifiedChannel] = []
        if len(occupied) == 0:
            return out
        # merge adjacent occupied bins into channel groups
        groups: list[list[int]] = [[int(occupied[0])]]
        for b in occupied[1:]:
            if b - groups[-1][-1] <= merge_bins:
                groups[-1].append(int(b))
            else:
                groups.append([int(b)])
        bin_hz = self.sample_rate / self.fft_size
        for g in groups:
            center_bin = int(round(np.mean(g)))
            freq = self.center_hz + (center_bin - self.fft_size // 2) * bin_hz
            occ = float(self.occupancy[g].mean())
            var = float(self.var[g].mean())
            mean_db = float(self.mean[g].mean())
            # steady high-occupancy, low-variance = control channel
            if occ > 0.85 and var < 12.0:
                kind = "control"
            elif occ > min_occupancy and var >= 12.0:
                kind = "voice"
            else:
                kind = "data"
            out.append(
                ClassifiedChannel(
                    frequency_hz=freq,
                    kind=kind,
                    occupancy=round(occ, 3),
                    mean_db=round(mean_db, 1),
                    variance_db=round(var, 1),
                )
            )
        return out
