"""P25 modems of the port: C4FM and CQPSK/LSM (Phase 1 and Phase 2) with
the shared simulcast equalizer (counterpart of ``wavecap_tpu/models/p25``)."""

from .c4fm import (
    DIBIT_SYMBOLS,
    C4fmConfig,
    C4fmState,
    c4fm_demodulate,
    c4fm_init,
    modulate_c4fm,
    modulate_c4fm_cyclic,
)
from .cqpsk import (
    CqpskConfig,
    CqpskState,
    cqpsk_demodulate,
    cqpsk_init,
    modulate_cqpsk,
    modulate_cqpsk_cyclic,
)

__all__ = [n for n in dir() if not n.startswith("_")]
