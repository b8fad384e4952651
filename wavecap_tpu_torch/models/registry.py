"""Demodulator registry: mode name -> (config class, init, demod fn).

Counterpart of ``wavecap_tpu/models/registry.py``: the six analog modes.
The reference's P25 soft-symbol modes raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from . import analog


class DemodSpec(NamedTuple):
    config_cls: type
    init: Callable[..., Any]
    demod: Callable[..., Any]


REGISTRY: dict[str, DemodSpec] = {
    "wbfm": DemodSpec(analog.WbfmConfig, analog.wbfm_init, analog.wbfm_demod),
    "nbfm": DemodSpec(analog.NbfmConfig, analog.nbfm_init, analog.nbfm_demod),
    "am": DemodSpec(analog.AmConfig, analog.am_init, analog.am_demod),
    "sam": DemodSpec(analog.SamConfig, analog.sam_init, analog.sam_demod),
    "usb": DemodSpec(analog.SsbConfig, analog.ssb_init, analog.ssb_demod),
    "lsb": DemodSpec(analog.SsbConfig, analog.ssb_init, analog.ssb_demod),
}

# the reference's modes that a later slice brings (ROADMAP Queue 1)
_NOT_PORTED = {
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
    spec = get_demod(mode)
    if mode.lower() in ("usb", "lsb"):
        kwargs.setdefault("mode", mode.lower())
    return spec.config_cls(sample_rate=sample_rate, **kwargs)
