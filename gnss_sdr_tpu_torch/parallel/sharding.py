"""Mesh and sharding helpers for the channel-parallel receiver.

The counterpart of ``gnss_sdr_tpu/parallel/sharding.py``. PyTorch has no
SPMD partitioner, so a sharded array here is a list of per-shard tensors,
one for each of this process's shards, each on its shard's device:

- :class:`Mesh`: an ordered tuple of devices on one named axis. On the
  card it is the first ``n`` visible cards. A *logical* mesh places ``n``
  shards on one device and must say so (``logical=True``): the CPU tests
  and the one-card checks use it. A mesh across processes
  (``gnss_sdr_tpu_torch.parallel.multihost``) holds this process's local
  shards; shard ``i`` of rank ``r`` is global shard
  ``r * len(devices) + i``, as in JAX.
- :func:`channel_sharding` / :func:`replicated` and
  :meth:`Sharding.place` (``jax.device_put``'s role) split a tensor along
  its channel axis or copy it once to each distinct device.
- :func:`shard_tracking_state` splits every leaf of a ``TrackState`` or
  ``FastState`` along its channel axis.
- :func:`gather` puts per-shard pieces back in channel order on one
  device (``multihost_utils.process_allgather``'s role): across processes
  it moves the pieces' bytes with ``torch.distributed.all_gather``.
"""

from __future__ import annotations

import dataclasses

import torch

from gnss_sdr_tpu_torch.device import resolve_device

CHANNEL_AXIS = "ch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of this process's shards. ``devices`` may repeat a device
    only on a ``logical`` mesh. ``rank`` and ``world`` are this process's
    place in a multi-process mesh (the default ``torch.distributed``
    process group)."""

    devices: tuple
    axis: str = CHANNEL_AXIS
    logical: bool = False
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) != len(devs) and not self.logical:
            raise ValueError("a device appears twice: pass logical=True for "
                             "a logical mesh of several shards on one device")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world}")
        object.__setattr__(self, "devices", devs)

    @property
    def local_size(self) -> int:
        """Shards held by this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return len(self.devices) * self.world

    @property
    def local_shards(self) -> range:
        """Global indices of this process's shards."""
        k = len(self.devices)
        return range(self.rank * k, (self.rank + 1) * k)

    @property
    def distinct_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, axis: str = CHANNEL_AXIS,
              device=None, logical: bool = False) -> Mesh:
    """1-D mesh of ``n_devices`` shards. On the card (the default device)
    without ``logical``: the first ``n_devices`` visible cards (default:
    all). With ``logical``: ``n_devices`` shards on the one ``device``
    (the CPU has one device, so a CPU mesh is logical)."""
    dev = resolve_device(device)
    if logical:
        if n_devices is None or n_devices < 1:
            raise ValueError("a logical mesh needs its number of shards")
        return Mesh(tuple([dev] * int(n_devices)), axis, logical=True)
    if dev.type != "cuda":
        raise ValueError(f"{dev} is one device: pass logical=True for a mesh "
                         "of several shards on it")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"{n} cards asked for, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: split into ``mesh.size`` pieces along
    ``dim`` (the first ``length % size`` of them one longer, as
    ``torch.tensor_split`` cuts; equal pieces on a multi-process mesh), or
    (``dim`` None) replicated."""

    mesh: Mesh
    dim: int | None = 0

    def place(self, x: torch.Tensor) -> list:
        """This process's pieces of ``x``, each on its shard's device. A
        split piece on the device ``x`` lies on is a view of ``x``; a
        replicated tensor is copied once to each distinct device."""
        mesh = self.mesh
        if self.dim is None:
            copies = {d: x if x.device == d else x.to(d)
                      for d in mesh.distinct_devices}
            return [copies[d] for d in mesh.devices]
        n, size = x.shape[self.dim], mesh.size
        if n % size and mesh.world > 1:
            raise ValueError(f"axis {self.dim} of length {n} does not split "
                             f"into {size} equal shards")
        cut = [g * (n // size) + min(g, n % size) for g in range(size + 1)]
        return [x.narrow(self.dim, cut[g], cut[g + 1] - cut[g]).to(d)
                for g, d in zip(mesh.local_shards, mesh.devices)]


def channel_sharding(mesh: Mesh, dim: int = 0) -> Sharding:
    """Split along the leading (channel) axis, or along ``dim``."""
    return Sharding(mesh, dim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_tracking_state(state, mesh: Mesh) -> list:
    """One state a shard of this process: every leaf whose leading axis is
    the channel axis (the ``active`` field's length) split along it, the
    other leaves replicated."""
    c = state[0].shape[0]
    split, rep = channel_sharding(mesh), replicated(mesh)
    leaves = [(split if t.dim() >= 1 and t.shape[0] == c else rep).place(t)
              for t in state]
    return [type(state)(*parts) for parts in zip(*leaves)]


def all_gather_pieces(mesh: Mesh, t: torch.Tensor) -> list:
    """Every process's ``t`` (one shape and dtype on all of them), in rank
    order, on ``t``'s device; only the bytes cross the process boundary."""
    import torch.distributed as dist

    raw = t.contiguous().reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(raw) for _ in range(mesh.world)]
    dist.all_gather(bufs, raw)
    return [b.view(t.dtype).reshape(t.shape) for b in bufs]


def gather(mesh: Mesh, parts, dim: int = 0, device=None):
    """The per-shard ``parts`` of this process (tensors, or states of one
    type) concatenated along ``dim`` in shard order on ``device`` (default
    the mesh's first device); on a multi-process mesh every process's
    pieces, in rank order, so each process returns the whole array."""
    parts = list(parts)
    dev = mesh.devices[0] if device is None else torch.device(device)
    if hasattr(parts[0], "_fields"):
        return type(parts[0])(*(gather(mesh, leaf, dim, dev)
                                for leaf in zip(*parts)))
    local = torch.cat([p.to(dev) for p in parts], dim=dim)
    if mesh.world == 1:
        return local
    return torch.cat(all_gather_pieces(mesh, local), dim=dim)
