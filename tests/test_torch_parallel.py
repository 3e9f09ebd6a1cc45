"""The port's sharded path (``gnss_sdr_tpu_torch/parallel/``, K8's plain
versions) on the CPU, against the JAX package on its 8 virtual CPU
devices (``tests/conftest.py``) and against the port's own unsharded
calls.

- K8's launch-argument structures match their C twins in
  ``csrc/collectives.cu`` field for field.
- Halo exchange (K8a): equal to ``halo_exchange_blocks`` for float32
  shards, per plane for the planar int8 ring's time shards (a shard
  length not divisible by 16), and the overlap-save window of
  ``tests/test_multihost.py``.
- Grid all-reduce (K8b): every shard holds the float32 sum in shard
  order to the bit, and ``allreduce_noncoherent_grid``'s within rtol 1e-5
  (``tests/test_multihost.py:32``).
- The mesh, the channel split of a tracking state and ``gather``.
- The scan engine's block on 16 channels over 8 shards and the fast
  engine's ring superblock (``fast_engine_sharded_case``): the sharded
  records equal the unsharded ones to the bit (each channel's periods are
  computed alone), and JAX's sharded ``_block_step`` within rtol 2e-5 /
  atol 2e-4 (``tests/test_parallel.py:48-53``) and JAX's
  ``_fast_engine_sharded_case`` within ``tests/test_torch_fused.py``'s
  tolerances.
- ``dryrun_multichip(8)`` (tracking block, PRN-sharded grid, fast
  superblock, each against one device) and ``entry()``.
- ``parallel/mp_worker.py`` in two gloo processes of two shards each
  against the same work in one process: prompts and fast records to the
  bit, halo exact, sums within rtol 1e-6 (``tests/test_multiprocess.py``).
"""

import ctypes
import os
import re
import socket
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.parallel import channel_sharding as jchannel_sharding
from gnss_sdr_tpu.parallel import make_mesh as jmake_mesh
from gnss_sdr_tpu.parallel import replicated as jreplicated
from gnss_sdr_tpu.parallel import shard_tracking_state as jshard_state
from gnss_sdr_tpu.parallel.multihost import \
    allreduce_noncoherent_grid as jallreduce
from gnss_sdr_tpu.parallel.multihost import halo_exchange_blocks as jhalo
from gnss_sdr_tpu.tracking import TrackingConfig as JConfig
from gnss_sdr_tpu.tracking import TrackingEngine as JEngine
from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
from gnss_sdr_tpu_torch.kernels import collectives as k8
from gnss_sdr_tpu_torch.parallel import (Mesh, channel_sharding, gather,
                                         make_mesh, shard_tracking_state)
from gnss_sdr_tpu_torch.parallel.dryrun import (_example_inputs,
                                                dryrun_multichip, entry,
                                                fast_engine_sharded_case)
from gnss_sdr_tpu_torch.parallel.engines import ShardedEngine, gather_outputs
from gnss_sdr_tpu_torch.parallel.multihost import (
    allreduce_noncoherent_grid, halo_exchange_blocks)
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig, TrackingEngine

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n=8):
    return make_mesh(n, device="cpu", logical=True)


def _struct_twins(cls, name):
    """(C fields of ``struct name`` in csrc/collectives.cu with their
    element counts, the ctypes structure's)."""
    with open(os.path.join(os.path.dirname(k8.__file__), "csrc",
                           "collectives.cu")) as fh:
        text = fh.read()
    assert int(re.search(r"kMaxShards = (\d+);", text).group(1)) \
        == k8.MAX_SHARDS
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    c = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.search(r"(\w+)(?:\[(\w+)\])?\s*$", decl.strip())
        if m:
            n = m.group(2)
            c.append((m.group(1), 1 if n is None else k8.MAX_SHARDS
                      if n == "kMaxShards" else int(n)))
    py = [(f, t._length_ if issubclass(t, ctypes.Array) else 1)
          for f, t in cls._fields_]
    return c, py


def test_halo_exchange_matches_jax():
    c, py = _struct_twins(k8.HaloArgs, "HaloArgs")
    assert c == py and len(c) == 10
    mesh, jmesh = _mesh(), jmake_mesh(8)
    reset_launches()
    rng = np.random.default_rng(0)
    shards = rng.standard_normal((8, 64)).astype(np.float32)
    got = halo_exchange_blocks(mesh, torch.from_numpy(shards), halo=16)
    want = np.asarray(jhalo(jmesh, shards, halo=16))
    assert got.shape == want.shape == (8, 80)
    assert np.array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[7, 64:].numpy(), 0.0)
    # overlap-save: a window across a shard edge is the contiguous stream's
    stream = np.arange(8 * 100, dtype=np.float32)
    out = halo_exchange_blocks(mesh, torch.from_numpy(stream.reshape(8, 100)),
                               halo=30).numpy()
    assert np.array_equal(out, np.asarray(jhalo(
        jmesh, stream.reshape(8, 100), halo=30)))
    np.testing.assert_array_equal(out[0, 95:125], stream[95:125])
    # the planar int8 ring cut into time shards (views of the ring), a
    # shard length that is no multiple of the 16-byte vector
    length, halo = 1001, 13
    ring = rng.integers(-128, 128, (2, 8 * length)).astype(np.int8)
    tring = torch.from_numpy(ring)
    pieces = channel_sharding(mesh, dim=1).place(tring)
    assert all(p.data_ptr() == tring[:, g * length:].data_ptr()
               for g, p in enumerate(pieces))          # views of the ring
    got = halo_exchange_blocks(mesh, pieces, halo)
    padded = np.concatenate([ring, np.zeros((2, halo), np.int8)], axis=1)
    for g, o in enumerate(got):
        assert o.shape == (2, length + halo) and o.dtype == torch.int8
        assert np.array_equal(o.numpy(),
                              padded[:, g * length:(g + 1) * length + halo])
    for plane in range(2):
        want = np.asarray(jhalo(jmesh, ring[plane].reshape(8, length), halo))
        assert np.array_equal(np.stack([o[plane].numpy() for o in got]),
                              want)
    assert LAUNCHES["halo_exchange"] == 0       # the plain version on the CPU


def test_allreduce_matches_jax():
    c, py = _struct_twins(k8.ReduceArgs, "ReduceArgs")
    assert c == py and len(c) == 6
    mesh = _mesh()
    reset_launches()
    rng = np.random.default_rng(1)
    grids = rng.standard_normal((8, 4, 32)).astype(np.float32)
    got = allreduce_noncoherent_grid(mesh, torch.from_numpy(grids)).numpy()
    want = np.asarray(jallreduce(jmake_mesh(8), grids))
    total = grids[0].copy()
    for g in grids[1:]:
        total = total + g                       # float32, in shard order
    for d in range(8):
        assert np.array_equal(got[d], total)
        np.testing.assert_allclose(got[d], want[d], rtol=1e-5)
    # the list form: one grid a shard
    parts = allreduce_noncoherent_grid(
        mesh, list(torch.from_numpy(grids).unbind(0)))
    assert all(np.array_equal(p.numpy(), total) for p in parts)
    assert LAUNCHES["grid_allreduce"] == 0


class _Mixed(NamedTuple):
    per_channel: torch.Tensor
    shared: torch.Tensor


def test_mesh_channel_split_and_gather():
    with pytest.raises(ValueError, match="logical"):
        make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="logical"):
        Mesh(("cpu", "cpu"))
    mesh = _mesh(4)
    assert mesh.size == mesh.local_size == 4 and mesh.logical
    assert list(mesh.local_shards) == [0, 1, 2, 3]
    eng = TrackingEngine(TrackingConfig(fs=1.0e5), 8, 400, device="cpu")
    state = _example_inputs(eng, seed=4)[0]
    parts = shard_tracking_state(state, mesh)
    assert len(parts) == 4
    for g, p in enumerate(parts):
        for name, leaf, whole in zip(state._fields, p, state):
            assert leaf.shape == (2,) + whole.shape[1:], name
            assert torch.equal(leaf, whole[2 * g:2 * g + 2]), name
    back = gather(mesh, parts)
    assert all(torch.equal(a, b) for a, b in zip(back, state))
    mixed = _Mixed(torch.arange(8.0), torch.arange(3.0))
    for p in shard_tracking_state(mixed, mesh):
        assert p.per_channel.shape == (2,)
        assert torch.equal(p.shared, mixed.shared)   # replicated
    with pytest.raises(ValueError, match="equal shards"):
        ShardedEngine(TrackingEngine(TrackingConfig(fs=1.0e5), 6, 400,
                                     device="cpu"), mesh)


def test_sharded_scan_block_matches_unsharded_and_jax():
    # the dry run's shapes: 2 channels a shard, 100 samples a code period
    n = 8
    eng = TrackingEngine(TrackingConfig(fs=1.0e5), 2 * n, 400, device="cpu")
    state, block_re, block_im, codes = _example_inputs(eng, seed=0)
    ref_state, ref = eng.process_block(state, block_re, block_im, codes)
    mesh = _mesh(n)
    sharded = ShardedEngine(eng, mesh)
    states, outs = sharded.process_block(sharded.shard_state(state),
                                         block_re, block_im, codes)
    got = gather_outputs(mesh, outs)["packed"]
    new_state = gather(mesh, states)
    assert torch.equal(got, ref["packed"])
    assert all(torch.equal(a, b) for a, b in zip(new_state, ref_state))
    assert bool((got[..., 0] > 0.5).any())
    # an int8 ring superblock from a nonzero base: each shard gets only
    # the window it reads, rebased to 0, and gives the same records
    ring = torch.from_numpy(np.random.default_rng(4).integers(
        -30, 30, size=(2, 2 * 400 + eng.overlap + 77), dtype=np.int8))
    _, ring_ref = eng.superblock_ring_i8(state, ring, 77, 2, codes)
    _, outs = sharded.superblock_ring_i8(sharded.shard_state(state), ring,
                                         77, 2, codes)
    assert torch.equal(gather_outputs(mesh, outs)["packed"],
                       ring_ref["packed"])

    from __graft_entry__ import _example_inputs as j_inputs

    je = JEngine(JConfig(fs=1.0e5), 2 * n, block_samples=400, scan_unroll=1)
    jmesh = jmake_mesh(n)
    js, jre, jim, jcodes = j_inputs(je, seed=0)
    js = jshard_state(js, jmesh)
    jre = jax.device_put(jre, jreplicated(jmesh))
    jim = jax.device_put(jim, jreplicated(jmesh))
    jcodes = jax.device_put(jcodes, jchannel_sharding(jmesh))
    js, jout = je._block_step(js, jre, jim, jcodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout["packed"]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(new_state.carrier_doppler_hz.numpy(),
                               np.asarray(js.carrier_doppler_hz),
                               rtol=2e-5, atol=1e-3)


def test_sharded_fast_superblock_matches_unsharded_and_jax():
    from __graft_entry__ import _fast_engine_sharded_case as j_case

    packed_1, packed_n = fast_engine_sharded_case(_mesh(), 8)
    assert packed_1.shape == packed_n.shape
    assert np.array_equal(packed_1, packed_n)
    _, pj = j_case(jmake_mesh(8), 8)
    pt = packed_n
    k = 4
    assert pj.shape == pt.shape == (2, 2, 16, 5 * k + 4)
    # tests/test_torch_fused.py's comparison of one fast superblock
    np.testing.assert_array_equal(pj[..., 5 * k + 2:], pt[..., 5 * k + 2:])
    bj = pj[..., :k].astype(np.float64) + pj[..., k:2 * k]
    bt = pt[..., :k].astype(np.float64) + pt[..., k:2 * k]
    assert np.max(np.abs(bj - bt)) < 0.02
    np.testing.assert_allclose(np.abs(pt[..., 2 * k:3 * k]),
                               np.abs(pj[..., 2 * k:3 * k]), rtol=0.02,
                               atol=1e-3 * np.abs(pj[..., 2 * k:3 * k]).max())
    assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
    assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0


def test_dryrun_multichip_and_entry():
    reset_launches()
    res = dryrun_multichip(8, device="cpu")
    assert torch.equal(res["block"], res["block_1"])
    assert torch.equal(res["grid"], res["grid_1"])
    assert res["grid"].shape == (16, 16, 256)
    assert np.array_equal(res["fast"], res["fast_1"])
    assert not any(LAUNCHES.values())            # plain versions only
    step, args = entry(device="cpu")
    new_state, out = step(*args)
    assert out["packed"].shape == (out["valid"].shape + (21,))
    assert bool(out["valid"].any())
    assert bool(torch.isfinite(out["prompt_re"]).all())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnss_sdr_tpu_torch.parallel.mp_worker",
         str(rank), "2", f"127.0.0.1:{port}", str(tmp_path),
         "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            logs.append(out.decode(errors="replace"))
            assert p.returncode == 0, logs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    data = np.load(tmp_path / "mp_out.npz")
    n_dev = int(data["n_dev"])
    assert n_dev == 4
    # the same program in one process, unsharded
    eng = TrackingEngine(TrackingConfig(fs=1.0e5), 2 * n_dev, 400,
                         device="cpu")
    state, block_re, block_im, codes = _example_inputs(eng, seed=11)
    ref = []
    for _ in range(3):
        state, out = eng.process_block(state, block_re, block_im, codes)
        ref.append(out["packed"][..., 4].numpy())
    ref = np.stack(ref)
    assert ref.shape == data["prompts"].shape
    assert np.array_equal(ref, data["prompts"])

    shards, haloed = data["halo_in"], data["haloed"]
    for d in range(n_dev):
        np.testing.assert_array_equal(haloed[d, :64], shards[d])
        if d < n_dev - 1:
            np.testing.assert_array_equal(haloed[d, 64:], shards[d + 1, :16])
        else:
            np.testing.assert_array_equal(haloed[d, 64:], 0.0)
    total = data["grids"].sum(axis=0)
    for d in range(n_dev):
        np.testing.assert_allclose(data["summed"][d], total, rtol=1e-6)
        np.testing.assert_array_equal(data["summed"][d], data["summed"][0])

    assert bool(data["fast_identical"])
    local_ref, _ = fast_engine_sharded_case(_mesh(1), n_dev)
    assert np.array_equal(local_ref, data["fast_packed"])
