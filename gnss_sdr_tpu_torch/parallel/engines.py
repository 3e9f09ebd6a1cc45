"""The engines' device programs on a mesh: channels (PRNs) split over the
shards.

In the JAX package sharding is the same jitted call on sharded inputs
(``__graft_entry__.py::dryrun_multichip``); the port has no SPMD
partitioner, so it loops over the shards. :class:`ShardedEngine` holds
one engine a shard, the caller's engine cut to the shard's channel slice
on the shard's device: each shard's call is one launch of the engine's
fused kernel (K3-loop for the scan engine, K1-loop for the fast engine)
over its own channels, with the shared input (the int8 ring, a block's
planes) copied once to each distinct device. Each channel's periods run
in a block of their own in those kernels, so the sharded records equal
the unsharded ones to the bit. :func:`pcps_grid` splits the PCPS grid
(K2) over its PRN axis the same way. :func:`gather_outputs` puts the
records back in channel order.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from gnss_sdr_tpu_torch.kernels.acq import pcps_magnitude_grid
from gnss_sdr_tpu_torch.parallel.sharding import (Mesh, channel_sharding,
                                                  gather, replicated,
                                                  shard_tracking_state)

#: the channel axis of each output of the engines' calls
CHANNEL_DIM = {"packed": -2, "prompt_re": -1, "prompt_im": -1}


def on_device(dev: torch.device):
    """The CUDA device context of ``dev`` (kernels launch on its current
    stream); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_engine(engine, n_channels: int, device):
    """A copy of the scan or fast ``engine`` for ``n_channels`` channels on
    ``device``: the same configuration and constants, its tensors moved
    there, its per-channel caches (the code bank, the launch constants)
    empty."""
    dev = torch.device(device)
    eng = copy.copy(engine)
    eng.n_channels = int(n_channels)
    if dev != engine.device:
        for name, v in vars(engine).items():
            if isinstance(v, torch.Tensor):
                setattr(eng, name, v.to(dev))
        eng.device = dev
    for name in ("_scan_consts", "_fast_consts"):
        vars(eng).pop(name, None)
    if hasattr(eng, "_bank_cache"):
        eng._bank_cache = None
    return eng


class ShardedEngine:
    """``engine`` (a ``TrackingEngine`` or ``FastTrackingEngine``) with its
    channels split evenly over ``mesh``: shard ``g`` tracks channels
    ``g * C / n`` to ``(g + 1) * C / n - 1``. States, code tables and
    banks travel as lists of this process's per-shard pieces."""

    def __init__(self, engine, mesh: Mesh):
        c = engine.n_channels
        if c % mesh.size:
            raise ValueError(f"{c} channels do not split into {mesh.size} "
                             "equal shards")
        self.engine, self.mesh = engine, mesh
        self.engines = [shard_engine(engine, c // mesh.size, d)
                        for d in mesh.devices]

    def shard_state(self, state) -> list:
        return shard_tracking_state(state, self.mesh)

    def shard_channels(self, x) -> list:
        """Split along the channel axis (code tables [C, L], a bank [C,
        ...]); a list is taken as already split."""
        return x if isinstance(x, list) else channel_sharding(
            self.mesh).place(x)

    def replicate(self, x) -> list:
        """One reference a shard, one copy a distinct device; a list is
        taken as already placed."""
        return x if isinstance(x, list) else replicated(self.mesh).place(x)

    def _run(self, name, states, *args):
        out_states, outs = [], []
        for g, (eng, st) in enumerate(zip(self.engines, states)):
            with on_device(eng.device):
                s, o = getattr(eng, name)(st, *(a[g] for a in args))
            out_states.append(s)
            outs.append(o)
        return out_states, outs

    def process_block(self, states, block_re, block_im, code_tables,
                      data_code_tables=None):
        """Each shard's ``process_block`` on the replicated block planes."""
        args = [self.replicate(block_re), self.replicate(block_im),
                self.shard_channels(code_tables)]
        if data_code_tables is not None:
            args.append(self.shard_channels(data_code_tables))
        return self._run("process_block", states, *args)

    def superblock_ring_i8(self, states, ring, base: int, n_blocks: int,
                           tables, data_code_tables=None):
        """Each shard's ``superblock_ring_i8`` on the replicated int8 ring;
        ``tables`` are the scan engine's code tables or the fast engine's
        bank (from ``get_bank``), split along the channel axis. Of a ring
        tensor only the window the superblock reads, ``[base, base +
        n_blocks * block + overlap)``, is replicated, and read from 0 (the
        kernels take ``base`` as a pointer offset only)."""
        n = len(self.engines)
        if not isinstance(ring, list):
            eng = self.engine
            need = int(base) + int(n_blocks) * eng.block_samples \
                + eng.overlap
            ring, base = ring[:, int(base):need], 0
        args = [self.replicate(ring), [int(base)] * n, [int(n_blocks)] * n,
                self.shard_channels(tables)]
        if data_code_tables is not None:
            args.append(self.shard_channels(data_code_tables))
        return self._run("superblock_ring_i8", states, *args)


def gather_outputs(mesh: Mesh, outs, device=None) -> dict:
    """The shards' output dicts as one, every entry concatenated along its
    channel axis in shard order (across processes too)."""
    return {k: gather(mesh, [o[k] for o in outs], CHANNEL_DIM[k], device)
            for k in outs[0]}


def pcps_grid(mesh: Mesh, x, code_fft, dopplers, c0: float, offset: int,
              eff: int) -> list:
    """The PCPS magnitude grid (K2) split over its PRN axis: each shard's
    ``pcps_magnitude_grid`` [P / n, D, eff] of its rows of ``code_fft``
    [P, N], on the replicated samples ``x`` and Doppler bins. Returns this
    process's shards' grids (``gather`` gives [P, D, eff])."""
    rep = replicated(mesh)
    xs, ds = rep.place(x), rep.place(dopplers)
    cfs = code_fft if isinstance(code_fft, list) else channel_sharding(
        mesh).place(code_fft)
    out = []
    for dev, xi, cf, di in zip(mesh.devices, xs, cfs, ds):
        with on_device(dev):
            out.append(pcps_magnitude_grid(xi, cf, di, c0, offset, eff))
    return out
