"""Demodulator registry: mode name -> (config class, init, demod fn).

Counterpart of ``wavecap_tpu/models/registry.py``; this slice ports
``nbfm``.  The reference's other modes raise ``NotImplementedError``
naming the ROADMAP work that brings them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from . import analog


class DemodSpec(NamedTuple):
    config_cls: type
    init: Callable[..., Any]
    demod: Callable[..., Any]


REGISTRY: dict[str, DemodSpec] = {
    "nbfm": DemodSpec(analog.NbfmConfig, analog.nbfm_init, analog.nbfm_demod),
}

# the reference's modes that later slices bring (ROADMAP Queue 1)
_NOT_PORTED = {
    "wbfm": "Queue 1 item 7 (K9 IIR filters)",
    "am": "Queue 1 item 7 (K9 IIR filters, AGC)",
    "sam": "Queue 1 item 7 (K9, K10 PLL)",
    "usb": "Queue 1 item 7 (K9 IIR filters)",
    "lsb": "Queue 1 item 7 (K9 IIR filters)",
    "p25-soft": "Queue 1 item 8 (K12 C4FM timing)",
    "p25-cqpsk-soft": "Queue 1 item 8 (K13 CQPSK)",
}


def get_demod(mode: str) -> DemodSpec:
    key = mode.lower()
    if key in REGISTRY:
        return REGISTRY[key]
    if key in _NOT_PORTED:
        raise NotImplementedError(f"demod mode {mode!r} is ROADMAP {_NOT_PORTED[key]}")
    raise ValueError(f"unknown demod mode {mode!r}; known: {sorted(REGISTRY)}")


def make_config(mode: str, sample_rate: int, **kwargs) -> Any:
    return get_demod(mode).config_cls(sample_rate=sample_rate, **kwargs)
