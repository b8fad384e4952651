"""Demodulator registry: mode name -> (config class, init, demod fn).

Counterpart of ``wavecap_tpu/models/registry.py``: the six analog modes
and the two P25 soft-symbol modes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from . import analog


class DemodSpec(NamedTuple):
    config_cls: type
    init: Callable[..., Any]
    demod: Callable[..., Any]


def _c4fm_soft(iq, state, cfg):
    """C4FM -> soft symbols in the (out, state) demod contract; the hard
    dibits are host-rederivable from soft."""
    from .p25 import c4fm

    soft, _dibits, state = c4fm.c4fm_demodulate(iq, state, cfg)
    return soft, state


def _cqpsk_soft(iq, state, cfg):
    from .p25 import cqpsk

    soft, _dibits, state = cqpsk.cqpsk_demodulate(iq, state, cfg)
    return soft, state


def _p25_specs():
    from .p25 import c4fm, cqpsk

    return {
        "p25-soft": DemodSpec(c4fm.C4fmConfig, c4fm.c4fm_init, _c4fm_soft),
        "p25-cqpsk-soft": DemodSpec(cqpsk.CqpskConfig, cqpsk.cqpsk_init, _cqpsk_soft),
    }


REGISTRY: dict[str, DemodSpec] = {
    "wbfm": DemodSpec(analog.WbfmConfig, analog.wbfm_init, analog.wbfm_demod),
    "nbfm": DemodSpec(analog.NbfmConfig, analog.nbfm_init, analog.nbfm_demod),
    "am": DemodSpec(analog.AmConfig, analog.am_init, analog.am_demod),
    "sam": DemodSpec(analog.SamConfig, analog.sam_init, analog.sam_demod),
    "usb": DemodSpec(analog.SsbConfig, analog.ssb_init, analog.ssb_demod),
    "lsb": DemodSpec(analog.SsbConfig, analog.ssb_init, analog.ssb_demod),
    **_p25_specs(),
}


def get_demod(mode: str) -> DemodSpec:
    try:
        return REGISTRY[mode.lower()]
    except KeyError:
        raise ValueError(f"unknown demod mode {mode!r}; known: {sorted(REGISTRY)}") from None


def make_config(mode: str, sample_rate: int, **kwargs) -> Any:
    spec = get_demod(mode)
    if mode.lower() in ("usb", "lsb"):
        kwargs.setdefault("mode", mode.lower())
    return spec.config_cls(sample_rate=sample_rate, **kwargs)
