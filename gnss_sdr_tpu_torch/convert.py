"""Carry the JAX package's state and tables into the port.

Every function takes plain numpy arrays (or objects whose fields convert
with ``np.asarray``: NamedTuples of JAX arrays, dataclasses), so this
module imports neither JAX nor the JAX package. The tests use it to start
both sides from identical inputs; the dtypes stay as they are (f32 on
the device, int32 offsets, bool masks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.ops.gaussian import GaussState
from gnss_sdr_tpu_torch.ops.kalman import KfState
from gnss_sdr_tpu_torch.tracking.engine import TrackState
from gnss_sdr_tpu_torch.tracking.fast_engine import FastState


def field_dict(obj) -> dict[str, np.ndarray]:
    """Numpy field dict of a NamedTuple, dataclass or mapping."""
    if hasattr(obj, "_asdict"):
        items = obj._asdict().items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = dict(obj).items()
    return {k: np.asarray(v) for k, v in items}


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One array onto ``device`` as a new tensor of the same dtype."""
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _state(cls, fields, device):
    dev = resolve_device(device)
    return cls(**{name: to_tensor(fields[name], dev)
                  for name in cls._fields})


def track_state(fields, device="cuda") -> TrackState:
    """Scan-engine state from a ``TrackState`` field dict."""
    return _state(TrackState, field_dict(fields), device)


def fast_state(fields, device="cuda") -> FastState:
    """Fast-engine state from a ``FastState`` field dict, the secondary
    wipe-off fields and the KF / Gaussian loop carries (``kf_x``,
    ``kf_p``, ``gs_niw``) included."""
    return _state(FastState, field_dict(fields), device)


def kf_state(fields, device="cuda") -> KfState:
    """KF loop state from a ``gnss_sdr_tpu.ops.kalman.KfState``."""
    return _state(KfState, field_dict(fields), device)


def gauss_state(fields, device="cuda") -> GaussState:
    """Gaussian loop state from a ``gnss_sdr_tpu.ops.gaussian.GaussState``
    (int32 NIW counters, float32 the rest)."""
    return _state(GaussState, field_dict(fields), device)


def state_numpy(state) -> dict[str, np.ndarray]:
    """Numpy field dict of a port state (one device-to-host copy each)."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def config(fields, cls):
    """Port config dataclass ``cls`` from a config's field dict (the JAX
    package's ``TrackingConfig``, ``AcqConfig`` or ``ReceiverConfig``)."""
    src = field_dict(fields) if not isinstance(fields, dict) else fields
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (v.item() if isinstance(v, np.ndarray) and v.ndim == 0
                      else v) for k, v in src.items() if k in names})


def code_tables(tables, device="cuda") -> torch.Tensor:
    """[C, L] float32 code tables (or a [C, P+1, T, W] code bank)."""
    return to_tensor(np.asarray(tables, dtype=np.float32),
                     resolve_device(device))


def code_bank(bank, data_bank=None, device="cuda") -> torch.Tensor:
    """The port's K1 bank from the JAX engine's ``_get_bank`` output and,
    for a pilot-tracked engine, its ``_get_data_bank`` output appended as
    one more tap: [C, P+1, T (+1), W]."""
    bank = np.asarray(bank, dtype=np.float32)
    if data_bank is not None:
        bank = np.concatenate(
            [bank, np.asarray(data_bank, dtype=np.float32)], axis=2)
    return to_tensor(bank, resolve_device(device))


def conditioner_state(chain, taps, tail, base: int, next_k: int,
                      n_in: int) -> None:
    """Carry a JAX ``SignalConditionerChain``'s streaming state (its
    ``taps``, ``_tail``, ``_base``, ``_next_k`` and ``_n_in``) into the
    port's ``chain``, so that its next ``apply_stream`` continues the
    JAX chain's stream. ``tail`` is ``None`` before the first chunk."""
    chain.taps = None if taps is None else np.array(taps, np.float32)
    if tail is None:
        chain._tail = None
    else:
        chain._tail = np.array(tail, np.complex64)
        chain._base = int(base)
        chain._next_k = int(next_k)
    chain._n_in = int(n_in)
