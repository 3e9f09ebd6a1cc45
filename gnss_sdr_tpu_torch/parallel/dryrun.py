"""Entry points: the one-device tracking step and the sharded dry run.

The counterpart of ``__graft_entry__.py`` (kept at the same tiny shapes):
:func:`entry` returns the scan engine's block step (the receiver's
steady-state tracking program, one K3-loop launch on the card) with
example arguments; :func:`dryrun_multichip` builds an ``n``-shard mesh,
splits the channel axis over it and runs one tracking block, one
PRN-sharded acquisition grid and one fast-engine ring superblock (the
production serving path), each held against the same call on one device:
the block's records and the fast superblock's packed records to the bit,
each shard's grid rows equal to the unsharded grid's.

    python -m gnss_sdr_tpu_torch.parallel.dryrun [--device cpu] [--shards n]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnss_sdr_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.acq import pcps_magnitude_grid
from gnss_sdr_tpu_torch.parallel.engines import (ShardedEngine,
                                                 gather_outputs, pcps_grid)
from gnss_sdr_tpu_torch.parallel.sharding import Mesh, gather, make_mesh
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig, TrackingEngine
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine


def _example_engine(n_channels=12, fs=4.0e6, block_ms=20, device=None):
    cfg = TrackingConfig(fs=fs)
    block_samples = int(fs * block_ms * 1e-3)
    return TrackingEngine(cfg, n_channels, block_samples, device=device)


def _example_inputs(engine, seed=0):
    """(state, block_re, block_im, codes) on the engine's device: seeded
    noise planes of one block, the C/A codes of PRN 1..C, each channel
    started at its own Doppler and code offset (the JAX entry's inputs,
    draw for draw)."""
    rng = np.random.default_rng(seed)
    n = engine.block_samples + engine.overlap
    block_re = rng.standard_normal(n).astype(np.float32)
    block_im = rng.standard_normal(n).astype(np.float32)
    codes = np.stack([np.asarray(gps_l1ca_code(prn), dtype=np.float32)
                      for prn in range(1, engine.n_channels + 1)])
    state = engine.init_state()
    for ch in range(engine.n_channels):
        state = engine.start_channel(
            state, ch, doppler_hz=float(250.0 * ch - 1500.0),
            offset_samples=37 * ch, cur_len=engine.cfg.samples_per_code)
    dev = engine.device
    return (state, torch.as_tensor(block_re, device=dev),
            torch.as_tensor(block_im, device=dev),
            torch.as_tensor(codes, device=dev))


def outputs(packed: torch.Tensor) -> dict:
    """A scan block's records [S, C, 15 + 2T] with the fields the JAX
    block step returns beside them (``valid``, the prompt)."""
    return dict(packed=packed, valid=packed[..., 0] > 0.5,
                prompt_re=packed[..., 4], prompt_im=packed[..., 5])


def entry(device=None):
    """(step, example_args) for the one-device check: ``step(state,
    block_re, block_im, codes)`` tracks one block and returns (new state,
    outputs)."""
    engine = _example_engine(device=device)
    args = _example_inputs(engine)

    def step(state, block_re, block_im, codes):
        new_state, out = engine.process_block(state, block_re, block_im,
                                              codes)
        return new_state, outputs(out["packed"])

    return step, args


def _mesh(n_devices: int, device) -> Mesh:
    """The first ``n_devices`` cards, or a logical mesh on one device (the
    CPU, or fewer cards than shards)."""
    dev = resolve_device(device)
    logical = dev.type == "cpu" or n_devices > torch.cuda.device_count()
    return make_mesh(n_devices, device=dev, logical=logical)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one channel-sharded tracking block, one PRN-sharded acquisition
    grid and one channel-sharded fast-engine ring superblock on an
    ``n_devices`` mesh (tiny shapes), each against the same call on one
    device; raises where they differ. Returns the sharded and unsharded
    results."""
    mesh = _mesh(n_devices, device)
    dev = mesh.devices[0]

    # --- tracking: channels sharded, sample block replicated -------------
    engine = TrackingEngine(TrackingConfig(fs=1.0e5), 2 * n_devices,
                            block_samples=400, device=dev)
    state, block_re, block_im, codes = _example_inputs(engine, seed=1)
    ref_state, ref = engine.process_block(state, block_re, block_im, codes)
    sharded = ShardedEngine(engine, mesh)
    states, outs = sharded.process_block(sharded.shard_state(state),
                                         block_re, block_im, codes)
    got = gather_outputs(mesh, outs, dev)["packed"]
    if not torch.equal(got, ref["packed"]) \
            or not torch.equal(gather(mesh, states, 0, dev).offset,
                               ref_state.offset):
        raise AssertionError("sharded tracking block diverged from the "
                             "single-device block")

    # --- acquisition: PRN axis sharded ------------------------------------
    n_prn, n_fft = 2 * n_devices, 256
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(n_fft).astype(np.float32)
         + 1j * rng.standard_normal(n_fft).astype(np.float32))
    cf = (rng.standard_normal((n_prn, n_fft)).astype(np.float32)
          + 1j * rng.standard_normal((n_prn, n_fft)).astype(np.float32))
    x = torch.as_tensor(x.astype(np.complex64), device=dev)
    cf = torch.as_tensor(cf.astype(np.complex64), device=dev)
    dopplers = torch.linspace(-5000.0, 5000.0, 16, dtype=torch.float32,
                              device=dev)
    c0 = float(np.float32(-2.0 * np.pi) / np.float32(1.0e5))
    grid_1 = pcps_magnitude_grid(x, cf, dopplers, c0, 0, n_fft)
    grid_n = gather(mesh, pcps_grid(mesh, x, cf, dopplers, c0, 0, n_fft),
                    0, dev)
    if not torch.equal(grid_1, grid_n):
        raise AssertionError("PRN-sharded acquisition grid diverged from "
                             "the single-device grid")

    # --- production fast engine: the steady-state serving path -----------
    packed_1, packed_n = fast_engine_sharded_case(mesh, n_devices)
    if not np.array_equal(packed_1, packed_n):
        raise AssertionError(
            "sharded fast-engine superblock diverged from single-device")
    return dict(block=got, block_1=ref["packed"], grid=grid_n, grid_1=grid_1,
                fast=packed_n, fast_1=packed_1)


def fast_engine_sharded_case(mesh: Mesh, n_devices: int):
    """Run the fast-engine ring superblock unsharded (on the mesh's first
    device) and channel-sharded over ``mesh``; return both packed record
    arrays as numpy (tiny shapes; on a multi-process mesh the sharded
    records of every process, gathered)."""
    dev = mesh.devices[0]
    fs = 1.0e5  # 100 samples per 1023-chip period
    n_channels = 2 * n_devices
    cfg = TrackingConfig(fs=fs, extend_correlation_symbols=4,
                         pll_bw_narrow_hz=5.0, dll_bw_narrow_hz=0.75)
    nb = 2
    codes = torch.as_tensor(np.stack(
        [np.asarray(gps_l1ca_code((ch % 32) + 1), dtype=np.float32)
         for ch in range(n_channels)]), device=dev)

    def build(shard: bool):
        rng = np.random.default_rng(5)
        engine = FastTrackingEngine(cfg, n_channels, groups_per_block=2,
                                    device=dev)
        cap = rng.integers(-30, 30, size=(
            2, nb * engine.block_samples + engine.overlap + 64),
            dtype=np.int8)
        state = engine.init_state()
        for ch in range(n_channels):
            state = engine.start_channel(
                state, ch, doppler_hz=float(100.0 * ch - 400.0),
                offset_samples=13 * ch)
        bank = engine.get_bank(codes)
        ring = torch.as_tensor(cap, device=dev)
        if not shard:
            _, out = engine.superblock_ring_i8(state, ring, 0, nb, bank)
            return out["packed"].cpu().numpy()
        sharded = ShardedEngine(engine, mesh)
        _, outs = sharded.superblock_ring_i8(sharded.shard_state(state),
                                             ring, 0, nb, bank)
        return gather_outputs(mesh, outs, dev)["packed"].cpu().numpy()

    return build(shard=False), build(shard=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=None)
    args = ap.parse_args(argv)
    step, example = entry(args.device)
    _, out = step(*example)
    print(f"entry step ok: {int(out['valid'].sum())} valid periods")
    dev = resolve_device(args.device)
    n = args.shards or (torch.cuda.device_count() if dev.type == "cuda"
                        else 8)
    dryrun_multichip(n, dev)
    print(f"dryrun ok on {n} shards")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
