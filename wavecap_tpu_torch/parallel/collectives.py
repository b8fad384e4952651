"""K15: the mesh's exchanges as explicit device-to-device copies.

Counterpart of the collectives in ``wavecap_tpu/parallel/sharded.py``
(the ``ppermute`` halo and history, the tiled ``all_to_all`` re-shard
and the ``all_gather`` of the wide IF, ``sharded.py:218-236,271,354``).
The reference is one program over ``jax.devices()`` whose XLA
collectives run inside a ``shard_map``; the port keeps that single
controller.  Each shard of a mesh is a device and a CUDA stream of its
own; an exchange is a ``copy_(..., non_blocking=True)`` per piece:

* the source shard's stream records an event and the destination's
  stream waits on it, so the copy follows the source's producer without
  a host sync;
* between two cards the copy is a peer copy over NVLink, which PyTorch
  runs on the source card's stream while the source shard's stream is
  current there; on one device (a mesh of repeated devices) it runs on
  the destination's stream, and the source tensor is ``record_stream``ed
  there;
* a repeated device still copies: no exchange aliases a view.

Every copy is counted, by label, with its bytes (:func:`copy_counts`).
On the CPU the shards have no streams and the copies run in order.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch

_LOCK = threading.Lock()
_COPIES: dict[str, list[int]] = {}  # label -> [copies, bytes]


@dataclass(eq=False)
class Shard:
    """One place of a mesh: a device and, on a card, the stream its work
    runs on."""

    device: torch.device
    stream: torch.cuda.Stream | None = None

    @classmethod
    def new(cls, device: torch.device) -> "Shard":
        return cls(device, torch.cuda.Stream(device) if device.type == "cuda" else None)

    @classmethod
    def current(cls, device: torch.device) -> "Shard":
        """The caller's place: ``device`` and its current stream."""
        return cls(device, torch.cuda.current_stream(device) if device.type == "cuda" else None)

    def use(self):
        """Context: this thread's work on ``device`` goes on the shard's stream."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def record(self) -> torch.cuda.Event | None:
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def wait(self, event: torch.cuda.Event | None) -> None:
        if event is not None and self.stream is not None:
            self.stream.wait_event(event)


def _count(label: str, nbytes: int) -> None:
    with _LOCK:
        c = _COPIES.setdefault(label, [0, 0])
        c[0] += 1
        c[1] += nbytes


def copy_counts() -> dict[str, dict[str, int]]:
    """Copies and bytes of each exchange label since the last reset."""
    with _LOCK:
        return {k: {"copies": v[0], "bytes": v[1]} for k, v in _COPIES.items()}


def reset_copy_counts() -> None:
    with _LOCK:
        _COPIES.clear()


def copy_to(src: torch.Tensor, src_shard: Shard, dst_shard: Shard, event, label: str,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """``src`` (produced on ``src_shard``, which recorded ``event`` after
    it) as a new tensor on ``dst_shard``, or into ``out`` there."""
    if not src.is_contiguous():
        raise ValueError("an exchange copies contiguous pieces")
    cross = src.device != dst_shard.device
    with src_shard.use() if cross else contextlib.nullcontext(), dst_shard.use():
        dst_shard.wait(event)
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype, device=dst_shard.device)
        out.copy_(src, non_blocking=True)
    if not cross and dst_shard.stream is not None and dst_shard.stream != src_shard.stream:
        src.record_stream(dst_shard.stream)  # read on the destination's stream
    _count(label, src.numel() * src.element_size())
    return out


def ppermute(parts: list, shards: list[Shard], pairs, label: str = "ppermute") -> list:
    """``jax.lax.ppermute``: shard ``j`` receives a copy of ``parts[i]`` for
    each ``(i, j)`` in ``pairs``; shards that receive nothing get None."""
    events = {i: shards[i].record() for i, _ in pairs}
    out: list = [None] * len(shards)
    for i, j in pairs:
        out[j] = copy_to(parts[i], shards[i], shards[j], events[i], label)
    return out


def all_to_all_tiled(blocks: list, shards: list[Shard], label: str = "all_to_all") -> list:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=1, tiled=True)``:
    shard ``d`` receives rows ``[d*m/n, (d+1)*m/n)`` of every shard's
    ``(m, s)`` block, concatenated along axis 1 in shard order:
    ``(m/n, n*s)``."""
    n = len(shards)
    m = blocks[0].shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not split over {n} shards")
    mb = m // n
    events = [s.record() for s in shards]
    out = []
    for d, dst in enumerate(shards):
        pieces = [copy_to(blocks[s][d * mb:(d + 1) * mb], shards[s], dst, events[s], label)
                  for s in range(n)]
        with dst.use():
            out.append(torch.cat(pieces, dim=1))
    return out


def all_gather(parts: list, shards: list[Shard], to: Shard | None = None, label: str = "all_gather"):
    """``jax.lax.all_gather``: the parts stacked in shard order, ``(n,) +
    part.shape``, on every shard (a list), or on ``to`` alone (where only
    one place consumes the result)."""
    events = [s.record() for s in shards]
    targets = shards if to is None else [to]
    out = []
    for dst in targets:
        with dst.use():
            buf = torch.empty((len(parts),) + tuple(parts[0].shape), dtype=parts[0].dtype,
                              device=dst.device)
        for s, part in enumerate(parts):
            copy_to(part, shards[s], dst, events[s], label, out=buf[s])
        out.append(buf)
    return out if to is None else out[0]


def scatter(x: torch.Tensor, src: Shard, shards: list[Shard], label: str = "scatter") -> list:
    """The row ``x`` split into equal pieces, one copied to each shard (the
    placement ``P('time')`` gives)."""
    n = len(shards)
    if x.dim() != 1 or x.shape[0] % n:
        raise ValueError(f"a row of {tuple(x.shape)} does not split over {n} shards")
    step = x.shape[0] // n
    event = src.record()
    return [copy_to(x[k * step:(k + 1) * step], src, sh, event, label) for k, sh in enumerate(shards)]


def replicate(x: torch.Tensor, src: Shard, shards: list[Shard], label: str = "scatter") -> list:
    """A copy of ``x`` on every shard (a replicated placement)."""
    event = src.record()
    return [copy_to(x, src, sh, event, label) for sh in shards]
