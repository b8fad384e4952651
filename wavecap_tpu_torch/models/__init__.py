"""Demodulator models of the port (NBFM in this slice)."""

from .analog import NbfmConfig, NbfmState, nbfm_demod, nbfm_init

__all__ = ["NbfmConfig", "NbfmState", "nbfm_demod", "nbfm_init"]
