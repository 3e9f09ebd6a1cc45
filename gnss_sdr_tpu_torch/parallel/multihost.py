"""Multi-card / multi-process collective patterns.

The counterpart of ``gnss_sdr_tpu/parallel/multihost.py``: channels
sharded across devices, IF time blocks sharded with an overlap-save halo,
acquisition grids reduced across devices.

- :func:`distributed_init` / :func:`init_cpu_multiprocess` start
  ``torch.distributed`` (NCCL between cards, gloo on the CPU) and
  :func:`process_mesh` gives this process's part of the global mesh
  (``devices_per_process`` local shards; global shard ``rank *
  devices_per_process + i``, as JAX numbers them).
- :func:`halo_exchange_blocks`: each time shard followed by its
  successor's first ``halo`` samples, the last one by zeros (K8a).
- :func:`allreduce_noncoherent_grid`: every shard gets the sum of all
  shards' dwell grids (K8b).

Within a process both are one launch of their kernel per card (their
plain versions on the CPU). Across processes ``torch.distributed`` moves
bytes only: the next rank's head by ``send``/``recv``, the other ranks'
grids by ``all_gather``; the assembly and the sum stay K8a and K8b on the
receiving card.
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.collectives import (grid_allreduce,
                                                    halo_exchange)
from gnss_sdr_tpu_torch.parallel.sharding import (CHANNEL_AXIS, Mesh,
                                                  all_gather_pieces)


def distributed_init(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Start ``torch.distributed`` (``coordinator`` ``host:port``; no
    arguments: the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
    environment). ``backend`` defaults to NCCL where CUDA is available,
    else gloo."""
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_mesh(devices_per_process: int = 1, device=None,
                 axis: str = CHANNEL_AXIS) -> Mesh:
    """This process's part of the global mesh after
    :func:`distributed_init`: ``devices_per_process`` shards on the CPU
    (a logical mesh) or on this process's cards (``cuda``: the visible
    cards from ``rank * devices_per_process % count`` on; the first of
    them becomes the current card, which NCCL's transfers use)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    k = int(devices_per_process)
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cpu":
        return Mesh(tuple([dev] * k), axis, logical=True, rank=rank,
                    world=world)
    count = torch.cuda.device_count()
    first = rank * k % count
    if first + k > count:
        raise ValueError(f"rank {rank} needs cards {first}..{first + k - 1}, "
                         f"{count} visible")
    torch.cuda.set_device(first)
    return Mesh(tuple(torch.device("cuda", first + i) for i in range(k)),
                axis, rank=rank, world=world)


def init_cpu_multiprocess(coordinator: str, num_processes: int,
                          process_id: int,
                          devices_per_process: int = 2) -> Mesh:
    """Multi-process CPU bring-up (gloo), the local test shape of a
    multi-node run; returns this process's mesh of
    ``devices_per_process`` logical CPU shards."""
    distributed_init(coordinator, num_processes, process_id, backend="gloo")
    return process_mesh(devices_per_process, device="cpu")


def _local(mesh: Mesh, x):
    """(list of this process's shards, stacked input or None)."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] != mesh.local_size:
            raise ValueError(f"{x.shape[0]} shards given, the mesh holds "
                             f"{mesh.local_size} here")
        return list(x.unbind(0)), x
    x = list(x)
    if len(x) != mesh.local_size:
        raise ValueError(f"{len(x)} shards given, the mesh holds "
                         f"{mesh.local_size} here")
    return x, None


def halo_exchange_blocks(mesh: Mesh, shards, halo: int,
                         axis: str = CHANNEL_AXIS):
    """Append each shard's successor's first ``halo`` samples; the last
    shard of the mesh gets zeros (stream end). ``shards``: this process's
    shards, a list (``[L]`` or planar ``[2, L]`` tensors on their devices)
    or one ``[n_local, L]`` tensor on a logical mesh; returns the same
    form with ``L + halo`` samples a row."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    local, stacked = _local(mesh, shards)
    next_head = _next_head(mesh, local, halo)
    if stacked is None:
        return halo_exchange(local, halo, next_head)
    out = torch.empty(stacked.shape[:-1] + (stacked.shape[-1] + halo,),
                      dtype=stacked.dtype, device=stacked.device)
    halo_exchange(local, halo, next_head, out=list(out.unbind(0)))
    return out


def _next_head(mesh: Mesh, local, halo: int):
    """The first ``halo`` samples of the next rank's first shard (None on
    the last rank or a one-process mesh); this rank's head goes to the
    previous rank. Bytes only cross the process boundary."""
    if mesh.world == 1:
        return None
    import torch.distributed as dist

    head = local[0][..., :halo].contiguous()
    send = None
    if mesh.rank > 0:
        send = dist.isend(head.reshape(-1).view(torch.uint8), mesh.rank - 1)
    got = None
    if mesh.rank < mesh.world - 1:
        raw = torch.empty(head.numel() * head.element_size(),
                          dtype=torch.uint8, device=head.device)
        dist.recv(raw, mesh.rank + 1)
        got = raw.view(head.dtype).reshape(head.shape).to(local[-1].device)
    if send is not None:
        send.wait()
    return got


def allreduce_noncoherent_grid(mesh: Mesh, grids, axis: str = CHANNEL_AXIS):
    """Sum the shards' acquisition magnitude grids (non-coherent dwell
    accumulation across devices and processes): this process's grids (a
    list of ``[D, N]`` float32 tensors, or one ``[n_local, D, N]`` tensor
    on a logical mesh) -> the same form, every shard holding the total
    summed in global shard order."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    local, stacked = _local(mesh, grids)
    local = [g.contiguous() for g in local]
    if mesh.world == 1:
        every, mine = local, None
    else:
        dev = local[0].device
        peers = all_gather_pieces(
            mesh, torch.stack([g.to(dev) for g in local]))
        every = [g for block in peers for g in block.unbind(0)]
        every[mesh.local_shards.start:mesh.local_shards.stop] = local
        mine = list(mesh.local_shards)
    if stacked is None:
        return grid_allreduce(every, mine)
    out = torch.empty_like(stacked)
    grid_allreduce(every, mine, out=list(out.unbind(0)))
    return out
