"""One process of a multi-process mesh, the counterpart of
``tests/mh_worker.py``.

Forms a ``torch.distributed`` mesh with the other workers, two shards a
process: on this process's two cards over NCCL (the default; rank ``r``
takes cards ``2r`` and ``2r + 1``), or with ``--device cpu`` on two
logical CPU shards over gloo. Across it, it runs:

- the scan engine's tracking block with the channel axis split over all
  shards (three blocks, the prompts gathered),
- the overlap-save halo exchange of IF time shards across the process
  boundary (K8a; the next rank's head moves as bytes),
- the non-coherent accumulation of dwell grids (K8b; the peers' grids
  move as bytes),
- the production fast engine's ring superblock with its channels split
  over all shards, against the same superblock unsharded in this
  process.

Rank 0 writes the gathered results to ``<outdir>/mp_out.npz``.

    python -m gnss_sdr_tpu_torch.parallel.mp_worker <rank> <nproc> \\
        <addr:port> <outdir> [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("coordinator", help="addr:port of rank 0")
    ap.add_argument("outdir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rank, outdir = args.rank, args.outdir

    import numpy as np
    import torch
    import torch.distributed as dist

    from gnss_sdr_tpu_torch.parallel.dryrun import (_example_inputs,
                                                    fast_engine_sharded_case)
    from gnss_sdr_tpu_torch.parallel.engines import (ShardedEngine,
                                                     gather_outputs)
    from gnss_sdr_tpu_torch.parallel.multihost import (
        allreduce_noncoherent_grid, distributed_init, halo_exchange_blocks,
        init_cpu_multiprocess, process_mesh)
    from gnss_sdr_tpu_torch.parallel.sharding import (channel_sharding,
                                                      gather)
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    torch.set_num_threads(1)
    if args.device == "cpu":
        mesh = init_cpu_multiprocess(args.coordinator, args.nproc, rank,
                                     devices_per_process=2)
    else:
        distributed_init(args.coordinator, args.nproc, rank, backend="nccl")
        mesh = process_mesh(2, device="cuda")
    try:
        n_dev = mesh.size
        # --- channel-sharded tracking over the global mesh ---------------
        engine = TrackingEngine(TrackingConfig(fs=1.0e5), 2 * n_dev,
                                block_samples=400, device=mesh.devices[0])
        state, block_re, block_im, codes = _example_inputs(engine, seed=11)
        sharded = ShardedEngine(engine, mesh)
        states = sharded.shard_state(state)
        tables = sharded.shard_channels(codes)
        prompts = []
        for _ in range(3):
            states, outs = sharded.process_block(states, block_re, block_im,
                                                 tables)
            prompts.append(gather_outputs(mesh, outs)["packed"][..., 4])
        prompts = torch.stack(prompts)

        # --- halo exchange of IF time shards across processes ------------
        rng = np.random.default_rng(3)
        # (one [1, 64] piece a shard, on its shard's device)
        shards = torch.from_numpy(
            rng.standard_normal((n_dev, 64)).astype(np.float32))
        mine = channel_sharding(mesh).place(shards)
        haloed = gather(mesh, halo_exchange_blocks(mesh, mine, halo=16))

        # --- cross-process non-coherent dwell accumulation ---------------
        grids = torch.from_numpy(
            rng.standard_normal((n_dev, 4, 32)).astype(np.float32) ** 2)
        mine = channel_sharding(mesh).place(grids)
        summed = gather(mesh, allreduce_noncoherent_grid(mesh, mine))

        # --- production fast engine sharded ACROSS the process mesh ------
        fast_1, fast_n = fast_engine_sharded_case(mesh, n_dev)
        if rank == 0:
            np.savez(os.path.join(outdir, "mp_out.npz"),
                     prompts=prompts.cpu().numpy(),
                     haloed=haloed.cpu().numpy(), halo_in=shards.numpy(),
                     grids=grids.numpy(), summed=summed.cpu().numpy(),
                     fast_packed=fast_n,
                     fast_identical=bool(np.array_equal(fast_1, fast_n)),
                     n_dev=n_dev)
        # every process stays until the gathers are done everywhere
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
