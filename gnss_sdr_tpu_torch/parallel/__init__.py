"""Multi-device scale-out of the receiver.

The channel axis (satellite PRN x signal) is the natural data-parallel
axis: tracking state and per-channel code tables split over a mesh of
devices while sample blocks are replicated (each device reads the same
IF stream slice and tracks its own subset of satellites); the
acquisition (PRN x Doppler) grid splits over PRNs the same way. The
counterpart of ``gnss_sdr_tpu/parallel/__init__.py``; PyTorch has no SPMD
partitioner, so a sharded array is a list of per-shard tensors and the
engines' calls loop over the shards (``parallel/engines.py``).
"""

from gnss_sdr_tpu_torch.parallel.sharding import (
    Mesh,
    channel_sharding,
    gather,
    make_mesh,
    replicated,
    shard_tracking_state,
)

__all__ = [
    "Mesh",
    "channel_sharding",
    "gather",
    "make_mesh",
    "replicated",
    "shard_tracking_state",
]
