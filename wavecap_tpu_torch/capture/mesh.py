"""Mesh capture backend: the multi-device path of the capture engine.

Counterpart of ``wavecap_tpu/capture/mesh.py``: :mod:`..parallel.sharded`
(the time-sharded channelizer with the halo exchange, the re-shard to
channel-parallel demod banks) behind the slot-bank program's calling
convention, ``(x_rows, state, ctl) -> (outs, state)``, so the engine's
reader, dispatch, fetch and fan-out are the same in both modes.

Enable with ``CaptureConfig.mesh = "stream=1,time=8"`` (axis sizes over
:func:`..utils.torchenv.devices`; ``WAVECAP_TORCH_DEVICE_COUNT`` repeats
one device).  The grid demodulates every channelizer bin: channels map to
bins, and activation, fine offset and squelch are per-bin control.  The
narrow analog modes share one grid (a per-bin ``bank_idx`` selects each
bin's bank, so a mode change needs no rebuild), the P25 banks ride the
grid's own-output banks, and wide (WBFM) channels run the grid's
raw-stream stage.
"""

from __future__ import annotations

import numpy as np

from .. import ops
from ..models.registry import make_config
from ..parallel.mesh import Mesh, device_grid
from ..parallel.sharded import (
    GridControl,
    ShardedGridConfig,
    control_from_numpy,
    grid_init,
    sharded_grid_step,
)
from ..utils.torchenv import DeviceLike, devices


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """``"stream=1,time=8"`` -> ``{"stream": 1, "time": 8}``: both axes, in
    the string's order."""
    axes: dict[str, int] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            name, size = part.split("=")
            axes[name.strip()] = int(size)
        except ValueError:
            raise ValueError(f"bad mesh spec segment {part!r} in {spec!r}") from None
    if set(axes) != {"stream", "time"}:
        raise ValueError(f"mesh spec must name exactly 'stream' and 'time' axes, got {spec!r}")
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axis sizes must be >= 1: {spec!r}")
    return axes


def build_mesh(spec: str, device: DeviceLike = None) -> Mesh:
    axes = parse_mesh_spec(spec)
    n = int(np.prod(list(axes.values())))
    devs = devices(device)
    if n > len(devs):
        raise ValueError(f"mesh {spec!r} needs {n} devices; only {len(devs)} available")
    return Mesh(device_grid(devs[:n], tuple(axes.values())), tuple(axes.keys()))


def mesh_banks2(pipe_cfg, entry) -> tuple:
    """Own-output grid banks beyond the base: ``((label, mode, cfg), ...)``,
    ``label`` the engine-facing output key ("p25" / "p25p2")."""
    from .pipeline import p25_cfg_for, p25p2_cfg_for

    banks = []
    if entry != "p25" and pipe_cfg.p25_capacity > 0:
        mode = "p25-cqpsk-soft" if pipe_cfg.p25_modulation == "cqpsk" else "p25-soft"
        banks.append(("p25", mode, p25_cfg_for(pipe_cfg)))
    if pipe_cfg.p25p2_capacity > 0:
        banks.append(("p25p2", "p25-cqpsk-soft", p25p2_cfg_for(pipe_cfg)))
    return tuple(banks)


def mesh_grid_cfg(pipe_cfg, entry) -> ShardedGridConfig:
    """Grid config for the capture's mode groups, ``entry`` the base bank:
    the first narrow group, "p25" (every bin runs the C4FM or CQPSK demod),
    or None (a wide-only capture: an inactive NBFM placeholder base)."""
    from .pipeline import p25_cfg_for

    wide_kw = dict(wide_groups=tuple(pipe_cfg.wide_groups),
                   wide_cfgs=tuple(pipe_cfg.wide_cfg(g) for g in pipe_cfg.wide_groups),
                   wide_export_baseband=pipe_cfg.export_wide_baseband)
    banks2 = mesh_banks2(pipe_cfg, entry)
    banks2_kw = dict(modes2=tuple(b[1] for b in banks2), demod_cfgs2=tuple(b[2] for b in banks2))
    ch = pipe_cfg.channelizer()
    if entry == "p25":
        mode = "p25-cqpsk-soft" if pipe_cfg.p25_modulation == "cqpsk" else "p25-soft"
        return ShardedGridConfig(channelizer=ch, mode=mode, demod_cfg=p25_cfg_for(pipe_cfg), **banks2_kw,
                                 **wide_kw)
    if entry is None:
        return ShardedGridConfig(channelizer=ch, mode="nbfm",
                                 demod_cfg=make_config("nbfm", int(ch.channel_rate),
                                                       audio_rate=pipe_cfg.audio_rate),
                                 **banks2_kw, **wide_kw)
    bank = pipe_cfg.bank_cfg(entry)
    extra_banks = tuple(pipe_cfg.bank_cfg(g) for g in pipe_cfg.narrow_modes if g != entry)
    return ShardedGridConfig(channelizer=ch, mode=bank.mode, demod_cfg=bank.demod_cfg, **banks2_kw,
                             extra_modes=tuple(b.mode for b in extra_banks),
                             extra_demod_cfgs=tuple(b.demod_cfg for b in extra_banks), **wide_kw)


def mesh_init(pipe_cfg, entry, mesh: Mesh):
    """The grid's initial state on the mesh (the reference's ``jit_mesh_init``)."""
    return grid_init(mesh_grid_cfg(pipe_cfg, entry), mesh)


def mesh_control(pipe_cfg, channels, center_hz: float, mesh: Mesh, entry) -> GridControl:
    """Per-bin control from the engine's channel handles, whose ``slot`` is
    the channelizer bin (wide channels: their wide slot)."""
    ch_cfg = pipe_cfg.channelizer()
    m = ch_cfg.channel_count
    fine = np.zeros((1, m), np.float32)
    active = np.zeros((1, m), bool)
    squelch = np.full((1, m), -1e9, np.float32)
    bank = np.zeros((1, m), np.int32)
    # bank 0 is narrow_modes[0] (the grid's base), banks 1.. the rest in order
    narrow = tuple(pipe_cfg.narrow_modes)
    w = pipe_cfg.wide_capacity
    wide_ctl = {g: {"offset_hz": np.zeros((1, w), np.float32), "active": np.zeros((1, w), bool),
                    "squelch_db": np.full((1, w), -1e9, np.float32)} for g in pipe_cfg.wide_groups}
    for ch in channels:
        if isinstance(ch.mode_group, tuple) and ch.mode_group[0] == "wide":
            wct = wide_ctl.get(ch.mode_group[1])
            if wct is None:
                continue
            wct["offset_hz"][0, ch.slot] = ch.spec.frequency_hz - center_hz
            wct["active"][0, ch.slot] = True
            if ch.spec.squelch_db is not None:
                wct["squelch_db"][0, ch.slot] = ch.spec.squelch_db
            continue
        off = ch.spec.frequency_hz - center_hz
        fine[0, ch.slot] = off - ch_cfg.channel_offset_hz(ch.slot)
        active[0, ch.slot] = True
        if ch.spec.squelch_db is not None:
            squelch[0, ch.slot] = ch.spec.squelch_db
        if narrow and ch.mode_group in narrow:
            bank[0, ch.slot] = narrow.index(ch.mode_group)
    return control_from_numpy(mesh_grid_cfg(pipe_cfg, entry), mesh, fine, active, squelch, bank,
                              wide_ctl or None)


def mesh_capture_multi(pipe_cfg, mesh: Mesh, entry):
    """The mesh counterpart of :func:`.pipeline.capture_multi` (the
    reference's ``jit_mesh_capture_multi``): ``multi(x_rows, state, ctl)``
    runs one sharded grid step per stacked block, with the slot-bank
    program's outputs (``spectrum``, ``banks[entry]`` or ``p25``, the
    own-output soft banks, ``wide``, ``_packed``) and a leading block axis."""
    from .pipeline import _stack, _to_complex, pack_wire

    gcfg = mesh_grid_cfg(pipe_cfg, entry)
    labels2 = tuple(b[0] for b in mesh_banks2(pipe_cfg, entry))
    gstep = sharded_grid_step(mesh, gcfg)

    def one_block(row, scale, state, ctl):
        # the spectrum's frames from the whole block, on the caller's device
        spectrum = ops.spectrogram_sampled(_to_complex(row, scale), pipe_cfg.fft_size,
                                           n_out=max(pipe_cfg.spectrum_frames, 1))
        g_out, state = gstep(row[None] if scale is None else (row[None], scale[None]), state, ctl)
        bank = {"audio": g_out["audio"][0], "rssi": g_out["rssi"][0]}
        if entry == "p25":
            out = {"spectrum": spectrum, "p25": {"soft": bank["audio"], "rssi": bank["rssi"]}}
        else:
            out = {"spectrum": spectrum, "banks": {entry: bank} if entry is not None else {}}
        for i, label in enumerate(labels2):
            out[label] = {"soft": g_out["audio2"][i][0], "rssi": g_out["rssi"][0]}
        if "wide" in g_out:
            out["wide"] = {g: {k: v[0] for k, v in leaves.items()} for g, leaves in g_out["wide"].items()}
        out["_packed"] = pack_wire(out)
        return out, state

    def multi(x_rows, state, ctl):
        rows, scales = x_rows if isinstance(x_rows, tuple) else (x_rows, None)
        outs = []
        for k in range(rows.shape[0]):
            out, state = one_block(rows[k], None if scales is None else scales[k], state, ctl)
            outs.append(out)
        return _stack(outs), state

    return multi
