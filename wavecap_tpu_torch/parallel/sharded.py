"""Sharded multi-device step: time-sharded channelizer, channel-sharded demod.

Counterpart of ``wavecap_tpu/parallel/sharded.py``, with its names:

  stage 1 -- each ``time`` shard channelizes its sub-block of the wideband
            stream (K1, K2); the history it needs is its left neighbour's
            last ``M*T`` samples, exchanged with ``ppermute`` (shard 0 uses
            the carry from the previous block);
  stage 2 -- an ``all_to_all`` over the ``time`` axis re-shards the
            channelizer output from (all channels, local time) to (local
            channels, all time), so each shard runs the stateful demods
            for a fixed subset of bins and their state never moves;
  stream axis -- a loop over the mesh's rows (the reference ``vmap``s).

The grid demodulates *every* bin, gated by per-bin control: K3 shifts
each bin by its fine offset and takes its RSSI (an identity row map),
then every bank's registry demod runs on the shard's ``(bins, n)`` rows,
so the slot banks' kernels carry the work.  Wide (WBFM) groups decimate
each shard's raw sub-block (K7, with the halo'd history as the FIR's
head) and gather the IF on the row's first shard.

The port is a single controller, as the reference: one process enqueues
every shard's work on that shard's CUDA stream and the exchanges are
device copies (:mod:`.collectives`, K15).  Per-shard state and control
are lists: ``[stream][time]`` for the bins, ``[stream]`` for what lives on
a row's first shard (the history, the wide demods).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import ops
from ..models.analog import wbfm_demod_baseband, wbfm_init
from ..models.channel_bank import ChannelAssignment, ChannelBankConfig, _stack_states, slot_frontend
from ..models.registry import get_demod
from ..ops.channelizer import ChannelizerConfig, _channelize, unpack_words
from ..ops.fir import design_decimation_fir, strided_fir
from ..ops.nco import _i64_to_u32, _u32_to_i64, tuning_word
from .collectives import Shard, all_gather, all_to_all_tiled, ppermute, replicate, scatter
from .mesh import Mesh


@dataclass(frozen=True)
class ShardedGridConfig:
    channelizer: ChannelizerConfig
    mode: str
    demod_cfg: Any
    # banks with their own outputs over the same bins (dual-rate trunking,
    # mixed analog + p25 (+ p25p2)): one output array each
    modes2: tuple = ()
    demod_cfgs2: tuple = ()
    # mixed analog modes folded into the one ``audio`` output: every bin is
    # demodulated by every bank and the per-bin ``bank_idx`` selects
    extra_modes: tuple = ()
    extra_demod_cfgs: tuple = ()
    # wide (WBFM) groups on the raw stream: one entry per dsp group
    wide_groups: tuple = ()
    wide_cfgs: tuple = ()  # pipeline.WideSlotConfig per group
    wide_export_baseband: bool = False
    # benchmark-only ablations: wrong results, the same shapes and compute
    # minus one exchange (the port's skip_halo reads each shard's own tail
    # where the reference reads the carried history: no copy either way)
    debug_skip_halo: bool = False
    debug_skip_reshard: bool = False


class GridState(NamedTuple):
    hist: tuple  # [stream]: (M*T,) complex64 history carry on the row's first shard
    demod_states: tuple  # [stream][time]: stacked demod state over the shard's M/n_time bins
    nco_phase: tuple  # [stream][time]: (M/n_time,) uint32
    demod_states2: tuple = ()  # [bank][stream][time]: own-output bank states (modes2)
    demod_states_extra: tuple = ()  # [bank][stream][time]: the mixed modes' states
    # [stream]: {dsp key: {"nco": [time] (W,) uint32 (replicated, as the
    # reference's), "demod": stacked WbfmState on the row's first shard}}, or None
    wide: Any = None


class GridControl(NamedTuple):
    """Per-bin control, ``[stream][time]`` tensors of the shard's bins."""

    fine_offset_hz: tuple
    active: tuple
    squelch_db: tuple
    bank_idx: Any = None  # [stream][time] int32 mixed-mode bank select
    # [stream][time]: {dsp key: {"offset_hz"/"active"/"squelch_db": (W,)}}
    wide: Any = None


def _bins_per_shard(cfg: ShardedGridConfig, mesh: Mesh) -> int:
    m = cfg.channelizer.channel_count
    n_time = mesh.shape["time"]
    if m % n_time != 0:
        raise ValueError(f"channel count {m} must divide by time shards {n_time}")
    return m // n_time


def _per_shard(mesh: Mesh, make) -> tuple:
    """``make(device)`` for every place: ``[stream][time]``."""
    return tuple(tuple(make(sh.device) for sh in row) for row in mesh.shards)


def grid_init(cfg: ShardedGridConfig, mesh: Mesh) -> GridState:
    mb = _bins_per_shard(cfg, mesh)
    hist_len = cfg.channelizer.channel_count * cfg.channelizer.taps_per_channel

    def bank_states(mode, demod_cfg):
        spec = get_demod(mode)
        return _per_shard(mesh, lambda d: _stack_states(spec.init(demod_cfg, device=d), mb))

    wide = None
    if cfg.wide_groups:
        wide = tuple(
            {gk: {"nco": tuple(torch.zeros(w.capacity, dtype=torch.uint32, device=sh.device) for sh in row),
                  "demod": _stack_states(wbfm_init(w.wbfm_cfg(), device=row[0].device), w.capacity)}
             for gk, w in zip(cfg.wide_groups, cfg.wide_cfgs)}
            for row in mesh.shards)
    return GridState(
        hist=tuple(torch.zeros(hist_len, dtype=torch.complex64, device=row[0].device)
                   for row in mesh.shards),
        demod_states=bank_states(cfg.mode, cfg.demod_cfg),
        nco_phase=_per_shard(mesh, lambda d: torch.zeros(mb, dtype=torch.uint32, device=d)),
        demod_states2=tuple(bank_states(mk, ck) for mk, ck in zip(cfg.modes2, cfg.demod_cfgs2)),
        demod_states_extra=tuple(bank_states(mk, ck) for mk, ck in zip(cfg.extra_modes, cfg.extra_demod_cfgs)),
        wide=wide,
    )


def control_from_numpy(cfg: ShardedGridConfig, mesh: Mesh, fine, active, squelch, bank_idx=None,
                       wide=None) -> GridControl:
    """Per-bin control ``(n_streams, M)`` numpy arrays (and the wide groups'
    ``{dsp key: {name: (n_streams, W)}}``) as the shards' tensors."""
    mb = _bins_per_shard(cfg, mesh)
    n_streams = mesh.shape["stream"]
    bank_idx = np.zeros((n_streams, mb * mesh.shape["time"]), np.int32) if bank_idx is None else bank_idx

    def on(a, device):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def split(a):
        return tuple(tuple(on(a[r, t * mb:(t + 1) * mb], sh.device) for t, sh in enumerate(row))
                     for r, row in enumerate(mesh.shards))

    wide_ctl = None
    if cfg.wide_groups:
        wide_ctl = tuple(tuple({gk: {k: on(np.asarray(v)[r], sh.device) for k, v in wide[gk].items()}
                                for gk in cfg.wide_groups} for sh in row) for r, row in enumerate(mesh.shards))
    return GridControl(split(np.asarray(fine, np.float32)), split(np.asarray(active, bool)),
                       split(np.asarray(squelch, np.float32)), split(np.asarray(bank_idx, np.int32)),
                       wide_ctl)


def control_init(cfg: ShardedGridConfig, mesh: Mesh) -> GridControl:
    s, m = mesh.shape["stream"], cfg.channelizer.channel_count
    wide = {gk: {"offset_hz": np.zeros((s, w.capacity), np.float32),
                 "active": np.zeros((s, w.capacity), bool),
                 "squelch_db": np.full((s, w.capacity), -1e9, np.float32)}
            for gk, w in zip(cfg.wide_groups, cfg.wide_cfgs)}
    return control_from_numpy(cfg, mesh, np.zeros((s, m), np.float32), np.zeros((s, m), bool),
                              np.full((s, m), -1e9, np.float32), wide=wide)


@lru_cache(maxsize=64)
def _identity_bins(mb: int, device: torch.device) -> torch.Tensor:
    # uploaded from the host (a copy that has finished when it returns):
    # built by a kernel on one shard's stream, another could read it first
    return torch.from_numpy(np.arange(mb, dtype=np.int32)).to(device)


@lru_cache(maxsize=16)
def _taps_on(decim: int, rate: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(design_decimation_fir(decim, rate)).to(device)


def sharded_grid_step(mesh: Mesh, cfg: ShardedGridConfig):
    """Build the sharded step for ``mesh``.

    Returns ``step(x, state, ctl) -> (out, state)`` where ``x`` is the
    ``(n_streams, N)`` wideband rows on the caller's device (complex64,
    interleaved f32 ``(n_streams, 2N)``, or transport words; ``(rows,
    scales)`` for the adaptive i8 / i4 words).  Each row is split over
    its mesh row's time shards; the outputs are gathered back to the
    caller's device and stream, which waits on every shard at the end.
    """
    ch = cfg.channelizer
    m, taps_per = ch.channel_count, ch.taps_per_channel
    hist_len = m * taps_per
    n_time = mesh.shape["time"]
    mb = _bins_per_shard(cfg, mesh)
    spec = get_demod(cfg.mode)
    specs2 = tuple(get_demod(mk) for mk in cfg.modes2)
    specs_extra = tuple(get_demod(mk) for mk in cfg.extra_modes)
    rate_full = float(ch.sample_rate)
    # K3 in its shifted-row mode over the shard's bins, identity row map
    front = ChannelBankConfig(channelizer=ch, mode="shift", demod_cfg=None, capacity=mb)
    wide_prep = []
    for gk, wcfg in zip(cfg.wide_groups, cfg.wide_cfgs):
        n_taps = len(design_decimation_fir(wcfg.decim, rate_full))
        if n_taps - 1 > hist_len:
            raise ValueError(f"wide decimator ({n_taps} taps) exceeds the mesh halo (M*T = {hist_len}); "
                             "raise taps_per_channel")
        wide_prep.append((gk, wcfg, n_taps))

    def wide_stage(shards, xcs, my_hist, wst, wct, gk, wcfg, n_taps, caller):
        """One wide group: each shard shifts and decimates its sub-block
        (K7, the halo'd history as the FIR's head), the IF is gathered on
        the row's first shard, and the WBFM demod runs there once: the
        reference replicates it on every time shard, whose outputs are equal."""
        local_n = xcs[0].shape[-1]
        if local_n % wcfg.decim != 0:
            raise ValueError(f"per-shard block ({local_n}) must divide by the wide decimation "
                             f"({wcfg.decim}); adjust block_seconds")
        nt = n_taps - 1
        total_n = local_n * n_time
        dec_local, nco_new = [], []
        for t, sh in enumerate(shards):
            with sh.use():
                off = wct[t][gk]["offset_hz"]
                phase0 = wst[gk]["nco"][t]
                # the reference's phases, u32: its shard start and next-block
                # phase step with tuning_word(+off) while the samples turn
                # with tuning_word(-off) (sharded.py:257-266)
                tw = _u32_to_i64(tuning_word(off, rate_full))
                start = _i64_to_u32(_u32_to_i64(phase0) + (t * local_n) * tw - nt * tw)
                seg = torch.cat([my_hist[t][hist_len - nt:], xcs[t]])
                dec, _, _ = strided_fir(seg, _taps_on(wcfg.decim, rate_full, sh.device), wcfg.decim,
                                        nco=(tuning_word(-off, rate_full), start))
                dec_local.append(dec)
                nco_new.append(_i64_to_u32(_u32_to_i64(phase0) + total_n * tw))
        first = shards[0]
        gathered = all_gather(dec_local, shards, to=first, label="wide_if")
        with first.use():
            dec_full = gathered.transpose(0, 1).reshape(gathered.shape[1], -1)
            rssi_w = ops.rssi_dbfs(dec_full)
            audio_w, fm_w, wd = wbfm_demod_baseband(dec_full, wst[gk]["demod"], wcfg.wbfm_cfg())
            act, sq = wct[0][gk]["active"], wct[0][gk]["squelch_db"]
            audio_w = ops.squelch_gate(audio_w, rssi_w, sq)
            audio_w = torch.where(act[:, None], audio_w, torch.zeros_like(audio_w))
            rssi_w = torch.where(act, rssi_w, torch.full_like(rssi_w, -200.0))
        out = {"audio": audio_w, "rssi": rssi_w}
        if cfg.wide_export_baseband:
            out["baseband"] = fm_w
        out = {k: all_gather([v], [first], to=caller, label="outputs")[0] for k, v in out.items()}
        return out, {"nco": tuple(nco_new), "demod": wd}

    def one_stream(r, x_row, scale, state, ctl, caller):
        shards = mesh.shards[r]
        xs = scatter(x_row, caller, shards)
        scales = replicate(scale, caller, shards) if scale is not None else [None] * n_time
        xcs_in, tails = [], []
        for t, sh in enumerate(shards):
            with sh.use():
                x = torch.complex(xs[t][0::2], xs[t][1::2]) if xs[t].dtype == torch.float32 else xs[t]
                if x.shape[-1] < hist_len:
                    raise ValueError(f"per-shard block ({x.shape[-1]}) must be >= channelizer history "
                                     f"M*T ({hist_len}) for halo exchange")
                xcs_in.append(x)
                # the halo this shard sends right: its last M*T samples, complex
                tail = x[x.shape[-1] - hist_len:]
                tails.append(tail if tail.is_complex() else unpack_words(tail, scales[t]))

        # --- halo exchange: the left neighbour's tail becomes my history
        if cfg.debug_skip_halo:
            my_hist = [state.hist[r]] + tails[1:]
        else:
            left = ppermute(tails, shards, [(i, i + 1) for i in range(n_time - 1)], label="halo")
            my_hist = [state.hist[r]] + left[1:]

        # --- stage 1: local channelize (K1, K2)
        xcs, chans_local = [], []
        for t, sh in enumerate(shards):
            with sh.use():
                x_c, chans, _ = _channelize(xcs_in[t], my_hist[t], ch, scales[t])
                xcs.append(x_c)
                chans_local.append(chans)  # (M, S_local)

        # --- re-shard: (M, S_local) -> (M/n_time, S_full)
        if cfg.debug_skip_reshard:
            chans_mine = []
            for t, sh in enumerate(shards):
                with sh.use():
                    chans_mine.append(chans_local[t][:mb].repeat(1, n_time))
        else:
            chans_mine = all_to_all_tiled(chans_local, shards, label="reshard")

        # --- wide (WBFM) groups off the raw stream
        wide_out, new_wide = {}, None
        if wide_prep:
            new_wide = {}
            for gk, wcfg, n_taps in wide_prep:
                wide_out[gk], new_wide[gk] = wide_stage(shards, xcs, my_hist, state.wide[r],
                                                        ctl.wide[r], gk, wcfg, n_taps, caller)

        # --- stage 2: every bank on my bins
        audio_p, rssi_p, audio2_p = [], [], [[] for _ in specs2]
        ds_new, nco_new = [], []
        ds_extra_new = [[] for _ in specs_extra]
        ds2_new = [[] for _ in specs2]
        for t, sh in enumerate(shards):
            with sh.use():
                active, squelch = ctl.active[r][t], ctl.squelch_db[r][t]
                assign = ChannelAssignment(_identity_bins(mb, sh.device), ctl.fine_offset_hz[r][t],
                                           active, squelch)
                shifted, rssi, phase1, _ = slot_frontend(chans_mine[t], assign, state.nco_phase[r][t],
                                                         None, front)
                audio, ds = spec.demod(shifted, state.demod_states[r][t], cfg.demod_cfg)
                for k, sp_k in enumerate(specs_extra):
                    audio_k, ds_k = sp_k.demod(shifted, state.demod_states_extra[k][r][t],
                                               cfg.extra_demod_cfgs[k])
                    ds_extra_new[k].append(ds_k)
                    audio = torch.where((ctl.bank_idx[r][t] == k + 1)[:, None], audio_k, audio)
                audio = ops.squelch_gate(audio, rssi, squelch)
                audio = torch.where(active[:, None], audio, torch.zeros_like(audio))
                rssi = torch.where(active, rssi, torch.full_like(rssi, -200.0))
                for k, sp2 in enumerate(specs2):
                    a2, d2 = sp2.demod(shifted, state.demod_states2[k][r][t], cfg.demod_cfgs2[k])
                    audio2_p[k].append(torch.where(active[:, None], a2, torch.zeros_like(a2)))
                    ds2_new[k].append(d2)
                audio_p.append(audio)
                rssi_p.append(rssi)
                ds_new.append(ds)
                nco_new.append(phase1)

        # --- next-block history: the stream's tail (the last shard's), to the first shard
        if cfg.debug_skip_halo:
            new_hist = tails[0]
        else:
            new_hist = ppermute(tails, shards, [(n_time - 1, 0)], label="history")[0]

        def gather(parts):
            g = all_gather(parts, shards, to=caller, label="outputs")
            return g.reshape((-1,) + tuple(g.shape[2:]))

        out = {"audio": gather(audio_p), "rssi": gather(rssi_p),
               "audio2": tuple(gather(p) for p in audio2_p), "wide": wide_out}
        return out, (new_hist, tuple(ds_new), tuple(nco_new), tuple(tuple(d) for d in ds2_new),
                     tuple(tuple(d) for d in ds_extra_new), new_wide)

    def stack_rows(parts):
        return parts[0][None] if len(parts) == 1 else torch.stack(parts)

    def step(x, state: GridState, ctl: GridControl):
        rows, scales = x if isinstance(x, tuple) else (x, None)
        n_streams = mesh.shape["stream"]
        if rows.shape[0] != n_streams:
            raise ValueError(f"{rows.shape[0]} rows for a mesh of {n_streams} streams")
        caller = Shard.current(rows.device)
        fork = caller.record()  # every shard starts after the caller's work so far
        for row in mesh.shards:
            for sh in row:
                sh.wait(fork)
        outs, parts = [], []
        for r in range(n_streams):
            o, p = one_stream(r, rows[r], None if scales is None else scales[r], state, ctl, caller)
            outs.append(o)
            parts.append(p)
        for row in mesh.shards:  # the caller's later work follows every shard's
            for sh in row:
                caller.wait(sh.record())
        out = {"audio": stack_rows([o["audio"] for o in outs]), "rssi": stack_rows([o["rssi"] for o in outs])}
        if specs2:
            out["audio2"] = tuple(stack_rows([o["audio2"][k] for o in outs]) for k in range(len(specs2)))
        if wide_prep:
            out["wide"] = {gk: {k: stack_rows([o["wide"][gk][k] for o in outs]) for k in outs[0]["wide"][gk]}
                           for gk, _, _ in wide_prep}
        new_state = GridState(
            hist=tuple(p[0] for p in parts),
            demod_states=tuple(p[1] for p in parts),
            nco_phase=tuple(p[2] for p in parts),
            demod_states2=tuple(tuple(p[3][k] for p in parts) for k in range(len(specs2))),
            demod_states_extra=tuple(tuple(p[4][k] for p in parts) for k in range(len(specs_extra))),
            wide=tuple(p[5] for p in parts) if wide_prep else None,
        )
        return out, new_state

    return step
