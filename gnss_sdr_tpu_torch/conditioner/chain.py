"""Signal conditioner container: DataTypeAdapter -> InputFilter ->
Resampler between the signal source and the receiver.

Port of ``gnss_sdr_tpu/conditioner/chain.py`` (the reference's
SignalConditioner block, signal_conditioner.cc:37-85, with the
input-filter adapters fir_filter.cc, freq_xlating_fir_filter.cc,
pulse_blanking_filter.cc, notch_filter.cc and the resamplers
direct_resampler_conditioner.cc, mmse_resampler_conditioner.cc).

The chain runs on ``device`` (the card by default): :meth:`apply` and
:meth:`apply_stream` take numpy complex samples and return numpy
complex64, with one host-to-device and one device-to-host copy per call;
every stage between is a K7 kernel (``kernels/conditioner.py``). The
translation NCO of ``Freq_Xlating_Fir_Filter`` is computed inside K7a
from the absolute input index, so no cos/sin table is built on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnss_sdr_tpu_torch.conditioner.fir import (design_lowpass_taps,
                                                fir_filter,
                                                freq_xlating_fir_filter)
from gnss_sdr_tpu_torch.conditioner.interference import (notch_filter_block,
                                                         pulse_blanking)
from gnss_sdr_tpu_torch.conditioner.resampler import (direct_resample,
                                                      mmse_resample)
from gnss_sdr_tpu_torch.device import resolve_device

SUPPORTED_INPUT_FILTERS = {
    "Pass_Through",
    "Fir_Filter",
    "Freq_Xlating_Fir_Filter",
    "Pulse_Blanking_Filter",
    "Notch_Filter",
    "Notch_Filter_Lite",
}
SUPPORTED_RESAMPLERS = {
    "Pass_Through",
    "Direct_Resampler",
    "Mmse_Resampler",
}
#: data-type adaptation happens in the source's ingest (sources/unpack.py
#: converts ishort/ibyte/cbyte to complex), so the adapter names are
#: accepted as documentation of the input format
SUPPORTED_ADAPTERS = {
    "Pass_Through",
    "Ishort_To_Complex",
    "Ibyte_To_Complex",
    "Byte_To_Short",
    "Ishort_To_Cshort",
    "Ibyte_To_Cshort",
    "Ibyte_To_Cbyte",
}


class SignalConditionerChain:
    """Configured conditioner pipeline; ``fs_out`` is the rate delivered
    to the receiver (must equal ``GNSS-SDR.internal_fs_sps``)."""

    def __init__(self, fs_in: float, input_filter: str = "Pass_Through",
                 if_freq_hz: float = 0.0, decimation: int = 1,
                 ntaps: int = 65, cutoff_hz: float | None = None,
                 transition_hz: float | None = None,
                 resampler: str = "Pass_Through",
                 resample_fs_out: float | None = None,
                 pb_threshold_sigma: float = 4.0,
                 notch_excision: float = 8.0, device="cuda"):
        if input_filter not in SUPPORTED_INPUT_FILTERS:
            raise ValueError(
                f"InputFilter.implementation={input_filter!r} is not "
                f"available; supported: {sorted(SUPPORTED_INPUT_FILTERS)}")
        if resampler not in SUPPORTED_RESAMPLERS:
            raise ValueError(
                f"Resampler.implementation={resampler!r} is not "
                f"available; supported: {sorted(SUPPORTED_RESAMPLERS)}")
        self.device = resolve_device(device)
        self.fs_in = fs_in
        self.input_filter = input_filter
        self.if_freq_hz = if_freq_hz
        self.decimation = max(1, int(decimation))
        self.resampler = resampler
        fs_mid = fs_in / self.decimation \
            if input_filter in ("Fir_Filter", "Freq_Xlating_Fir_Filter") \
            else fs_in
        self.fs_mid = fs_mid
        self.fs_out = float(resample_fs_out or fs_mid) \
            if resampler != "Pass_Through" else fs_mid
        self.pb_threshold_sigma = pb_threshold_sigma
        self.notch_excision = notch_excision
        self.taps = None
        if input_filter in ("Fir_Filter", "Freq_Xlating_Fir_Filter"):
            cut = cutoff_hz if cutoff_hz is not None else 0.45 * fs_mid
            trans = transition_hz if transition_hz is not None \
                else 0.1 * fs_mid
            self.taps = design_lowpass_taps(fs_in, cut, trans, ntaps)
        # streaming state: carried tail (ntaps-1 raw samples) + absolute
        # sample counter for the translation NCO's phase continuity
        self._tail: np.ndarray | None = None
        self._n_in: int = 0
        #: wall seconds of the last call: host->device copy, device work
        #: (kernels and FFTs), device->host copy
        self.timings: dict[str, float] = {}

    # -- one-shot over a full capture -------------------------------------
    def apply(self, x: np.ndarray) -> np.ndarray:
        """Condition a complex capture; returns complex64 at fs_out."""
        return self._run(x, n0=0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, x: np.ndarray, n0: int) -> np.ndarray:
        t0 = time.perf_counter()
        xt = torch.from_numpy(np.ascontiguousarray(x, np.complex64)).to(
            self.device)
        self._sync()
        t1 = time.perf_counter()
        y = self._apply_tensor(xt, n0)
        self._sync()
        t2 = time.perf_counter()
        out = y.cpu().numpy()
        self.timings = {"h2d_s": t1 - t0, "device_s": t2 - t1,
                        "d2h_s": time.perf_counter() - t2}
        return out

    def _apply_tensor(self, x, n0: int):
        """The chain on complex64 samples on ``self.device``; ``n0`` is the
        absolute input index of ``x[0]``."""
        if self.input_filter == "Freq_Xlating_Fir_Filter":
            # phase-continuous translation across stream chunks: K7a takes
            # the NCO argument from the absolute input-sample index, in
            # float64 modulo 2*pi
            x = freq_xlating_fir_filter(x, self.taps, self.if_freq_hz,
                                        self.fs_in, self.decimation, n0)
        elif self.input_filter == "Fir_Filter":
            x = fir_filter(x, self.taps, self.decimation)
        elif self.input_filter == "Pulse_Blanking_Filter":
            x = pulse_blanking(x, self.pb_threshold_sigma)
        elif self.input_filter in ("Notch_Filter", "Notch_Filter_Lite"):
            x = notch_filter_block(x, self.notch_excision)
        if self.resampler == "Mmse_Resampler":
            x = mmse_resample(x, self.fs_mid, self.fs_out)
        elif self.resampler == "Direct_Resampler":
            x = direct_resample(x, self.fs_mid, self.fs_out)
        return x

    # -- streaming (live sources) -----------------------------------------
    def apply_stream(self, chunk: np.ndarray) -> np.ndarray:
        """Condition a stream chunk so chunked outputs concatenate to the
        one-shot :meth:`apply` result (GNU Radio history semantics,
        gnss_flowgraph ring buffers): a raw-sample tail is carried across
        calls, the buffer base is kept decimation-aligned so the
        decimator phase is global, and the translation NCO runs on
        absolute sample indices."""
        if self.resampler != "Pass_Through":
            raise NotImplementedError(
                "streaming conditioner supports filter chains only; "
                "resamplers need the one-shot apply() path")
        d = self.decimation
        ntaps = 0 if self.taps is None else len(self.taps)
        if self._tail is None:
            self._tail = np.zeros(0, dtype=np.complex64)
            self._base = 0        # global input index of tail[0], % d == 0
            self._next_k = 0      # next output (decimated) index to emit
        x = np.concatenate([self._tail, chunk.astype(np.complex64)])
        y = self._run(x, n0=self._base)
        # local output k <-> global input self._base + k*d
        k0 = self._next_k - self._base // d
        out = y[k0:]
        self._next_k += len(out)
        self._n_in = self._base + len(x)
        # keep >= ntaps-1 raw samples of history, base decimation-aligned
        keep_from_global = max(self._n_in - max(ntaps - 1, 0), 0) // d * d
        self._tail = x[keep_from_global - self._base:]
        self._base = keep_from_global
        return out
