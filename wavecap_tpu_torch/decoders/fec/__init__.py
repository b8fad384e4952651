"""Forward error correction codecs for P25 (host-side numpy)."""

from . import bch, crc, golay, trellis

__all__ = ["bch", "crc", "golay", "trellis"]
