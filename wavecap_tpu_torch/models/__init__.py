"""Demodulator models of the port: the analog modes."""

from .analog import (
    WbfmConfig,
    WbfmState,
    wbfm_init,
    wbfm_demod,
    wbfm_demod_baseband,
    NbfmConfig,
    NbfmState,
    nbfm_init,
    nbfm_demod,
    AmConfig,
    AmState,
    am_init,
    am_demod,
    SsbConfig,
    SsbState,
    ssb_init,
    ssb_demod,
    SamConfig,
    SamState,
    sam_init,
    sam_demod,
)
from .registry import REGISTRY, DemodSpec, get_demod, make_config

__all__ = [n for n in dir() if not n.startswith("_")]
