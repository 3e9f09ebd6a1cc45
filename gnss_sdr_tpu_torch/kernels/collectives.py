"""K8 wrappers: the sharded receiver's two collectives.

Two kernels of ``csrc/collectives.cu``, each taking one tensor per shard
(on one card, on the cards of this process, or received by
``torch.distributed`` from another process):

- :func:`halo_exchange` (K8a): each shard followed by its successor's
  first ``halo`` samples, the last shard by zeros (the ppermute +
  concatenate of ``gnss_sdr_tpu/parallel/multihost.py::
  halo_exchange_blocks``);
- :func:`grid_allreduce` (K8b): the shards' float32 grids summed in shard
  order, the total written for every shard asked for (the psum of
  ``allreduce_noncoherent_grid``).

On the CPU each wrapper runs its ``*_plain`` PyTorch version; for CUDA
tensors it launches its kernel once per card that holds an output. A
kernel reads a tensor on another card of this process over peer access,
which the wrapper enables; where ``torch.cuda.can_device_access_peer`` is
false it copies what the kernel reads to the reading card first and counts
that copy in ``STAGED``. Nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb

#: shards a launch addresses (``kMaxShards`` of ``csrc/collectives.cu``)
MAX_SHARDS = 32
#: copies to the reading card made because it cannot read a peer's memory
STAGED: dict[str, int] = {"halo_exchange": 0, "grid_allreduce": 0}


class HaloArgs(ctypes.Structure):
    """``struct HaloArgs`` of ``csrc/collectives.cu``."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SHARDS),
                ("succ", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("src_stride", ctypes.c_longlong * MAX_SHARDS),
                ("succ_stride", ctypes.c_longlong * MAX_SHARDS),
                ("dst_stride", ctypes.c_longlong),
                ("body", ctypes.c_longlong),
                ("halo", ctypes.c_longlong),
                ("n", ctypes.c_int),
                ("rows", ctypes.c_int)]


class ReduceArgs(ctypes.Structure):
    """``struct ReduceArgs`` of ``csrc/collectives.cu``."""

    _fields_ = [("grids", ctypes.c_void_p * MAX_SHARDS),
                ("out", ctypes.c_void_p * MAX_SHARDS),
                ("n_in", ctypes.c_int),
                ("n_out", ctypes.c_int),
                ("numel", ctypes.c_longlong),
                ("vec", ctypes.c_int)]


# ---- plain versions ----------------------------------------------------------

def halo_exchange_plain(shards, halo: int, next_head=None):
    """[shard d | shards[d + 1][..., :halo]] for every shard, the last one
    followed by ``next_head[..., :halo]`` or, without it, zeros."""
    succ = list(shards[1:]) + [next_head]
    out = []
    for x, s in zip(shards, succ):
        tail = (torch.zeros(x.shape[:-1] + (halo,), dtype=x.dtype,
                            device=x.device) if s is None
                else s[..., :halo].to(x.device))
        out.append(torch.cat([x, tail], dim=-1))
    return out


def grid_allreduce_plain(grids, local=None):
    """The grids summed in order 0..n-1 (float32), one copy of the total
    for each shard index in ``local`` (default: every shard) on that
    shard's device."""
    total = grids[0].clone()
    for g in grids[1:]:
        total = total + g.to(total.device)
    local = range(len(grids)) if local is None else local
    return [total.to(grids[i].device, copy=True) for i in local]


# ---- kernels -----------------------------------------------------------------

def _card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on one kind of device expected, "
                         f"got {t.device}")


def _readable(src: torch.Tensor, dev: torch.device, what: str):
    """``src`` as the card ``dev`` reads it: itself where it lies on
    ``dev`` or on a peer ``dev`` may read (peer access enabled here), else
    a copy on ``dev``, counted in ``STAGED[what]``."""
    if src.device == dev:
        return src
    if torch.cuda.can_device_access_peer(dev.index, src.device.index):
        _enable_peer(dev.index, src.device.index)
        return src
    STAGED[what] += 1
    return src.to(dev)


_peers: set[tuple[int, int]] = set()


def _enable_peer(dev: int, peer: int) -> None:
    if (dev, peer) in _peers:
        return
    err = kb.function("collectives", "enable_peer_access",
                      [kb.I32, kb.I32])(dev, peer)
    kb.check(err, f"enable_peer_access({dev}, {peer})")
    _peers.add((dev, peer))


def _rows(x: torch.Tensor):
    """(rows, bytes between rows) of a 1-D or 2-D shard whose rows are
    contiguous."""
    if x.dim() not in (1, 2) or x.stride(-1) != 1:
        raise ValueError("halo_exchange: 1-D or 2-D shards with contiguous "
                         "rows expected")
    if x.dim() == 1:
        return 1, 0
    return x.shape[0], x.stride(0) * x.element_size()


def _launch(fn, args, dev: torch.device, reads, what: str) -> None:
    """One launch of ``fn(args)`` on card ``dev``'s current stream, queued
    after the work of the other cards whose memory it reads (``reads``)
    and before their later work (which may reuse that memory)."""
    others = {t.device for t in reads if t.device != dev}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for o in others:
            stream.wait_stream(torch.cuda.current_stream(o))
        err = kb.launch(fn, dev, ctypes.byref(args))
        kb.check(err, what)
        for o in others:
            torch.cuda.current_stream(o).wait_stream(stream)
    LAUNCHES[what] += 1


def _by_device(tensors):
    """{device: [indices]} in first-seen order."""
    groups: dict[torch.device, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


def halo_exchange(shards, halo: int, next_head=None, out=None):
    """K8a: for each of the ``n`` shards (1-D ``[L]`` or 2-D ``[R, L]``
    tensors of one dtype whose rows are contiguous, e.g. the planar int8
    ring's time slices), ``[shard d | first halo samples of shard d + 1]``
    ``[..., L + halo]``; the last shard is followed by ``next_head``'s
    first ``halo`` samples (the head of the next process's first shard)
    or, without it, by zeros. ``out`` gives the destination tensors
    (contiguous rows of ``L + halo``, e.g. the rows of one ``[n, L +
    halo]`` tensor); by default each is allocated on its shard's device.
    Returns the list of outputs."""
    shards = list(shards)
    n = len(shards)
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"halo_exchange: 1 to {MAX_SHARDS} shards")
    x0 = shards[0]
    length = x0.shape[-1]
    if any(x.shape != x0.shape or x.dtype != x0.dtype for x in shards) \
            or (next_head is not None and (next_head.dtype != x0.dtype
                                           or next_head.shape[:-1]
                                           != x0.shape[:-1])):
        raise ValueError("halo_exchange: shards of one shape and dtype "
                         "expected")
    if not 0 <= halo <= length or (next_head is not None
                                   and next_head.shape[-1] < halo):
        raise ValueError(f"halo_exchange: halo {halo} outside [0, {length}]")
    if x0.device.type == "cpu":
        res = halo_exchange_plain(shards, halo, next_head)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return list(out)
    for x in shards + ([] if next_head is None else [next_head]):
        _card(x, "halo_exchange")
    shape = x0.shape[:-1] + (length + halo,)
    if out is None:
        out = [torch.empty(shape, dtype=x0.dtype, device=x.device)
               for x in shards]
    out = list(out)
    if len(out) != n or any(
            o.shape != shape or o.dtype != x0.dtype or o.device != x.device
            or o.stride(-1) != 1 or _rows(o)[1] != _rows(out[0])[1]
            for o, x in zip(out, shards)):
        raise ValueError("halo_exchange: one output [..., L + halo] with "
                         "contiguous rows a shard, on its device")
    rows = _rows(x0)[0]
    eb = x0.element_size()
    succ = shards[1:] + [next_head]
    fn = kb.function("collectives", "halo_exchange",
                     [ctypes.POINTER(HaloArgs), kb.VP])
    for dev, part in _by_device(shards).items():
        a = HaloArgs()
        keep = []
        for j, d in enumerate(part):
            a.src[j] = shards[d].data_ptr()
            a.src_stride[j] = _rows(shards[d])[1]
            a.dst[j] = out[d].data_ptr()
            s = succ[d]
            if s is None or halo == 0:
                a.succ[j] = None
                continue
            s = _readable(s if s.device == dev else s[..., :halo], dev,
                          "halo_exchange")
            keep.append(s)
            a.succ[j] = s.data_ptr()
            a.succ_stride[j] = _rows(s)[1]
        a.dst_stride = _rows(out[part[0]])[1]
        a.body, a.halo = length * eb, halo * eb
        a.n, a.rows = len(part), rows
        _launch(fn, a, dev, keep, "halo_exchange")
    return out


def grid_allreduce(grids, local=None, out=None):
    """K8b: the ``n`` float32 grids (one a shard, in shard order, any
    shape, all alike) summed in order 0..n-1; one output holding the total
    for each shard index in ``local`` (default every shard), on that
    shard's device. ``out`` gives the destination tensors (contiguous), by
    default allocated. Returns the list of outputs."""
    grids = list(grids)
    if not 1 <= len(grids) <= MAX_SHARDS:
        raise ValueError(f"grid_allreduce: 1 to {MAX_SHARDS} grids")
    g0 = grids[0]
    if any(g.shape != g0.shape or g.dtype != torch.float32
           or not g.is_contiguous() for g in grids):
        raise ValueError("grid_allreduce: contiguous float32 grids of one "
                         "shape expected")
    local = list(range(len(grids))) if local is None else list(local)
    if g0.device.type == "cpu":
        res = grid_allreduce_plain(grids, local)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return list(out)
    for g in grids:
        _card(g, "grid_allreduce")
    if out is None:
        out = [torch.empty_like(grids[i]) for i in local]
    out = list(out)
    if len(out) != len(local) or any(
            o.shape != g0.shape or o.dtype != torch.float32
            or not o.is_contiguous() or o.device != grids[i].device
            for o, i in zip(out, local)):
        raise ValueError("grid_allreduce: one contiguous float32 output a "
                         "local shard, on its device")
    fn = kb.function("collectives", "grid_allreduce",
                     [ctypes.POINTER(ReduceArgs), kb.VP])
    for dev, part in _by_device([grids[i] for i in local]).items():
        a = ReduceArgs()
        ins = [_readable(g, dev, "grid_allreduce") for g in grids]
        for k, t in enumerate(ins):
            a.grids[k] = t.data_ptr()
        for j, p in enumerate(part):
            a.out[j] = out[p].data_ptr()
        a.n_in, a.n_out = len(ins), len(part)
        a.numel = g0.numel()
        a.vec = int(all(t.data_ptr() % 16 == 0 for t in ins)
                    and all(out[p].data_ptr() % 16 == 0 for p in part))
        _launch(fn, a, dev, ins, "grid_allreduce")
    return out
