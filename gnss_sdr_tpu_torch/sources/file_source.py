"""File signal source: reads IF captures in any reference item_type.

Supported ``item_type`` strings follow the reference conventions
(file_source_base.cc / gnss_block_factory):

- ``gr_complex``: interleaved float32 I,Q
- ``cshort``: interleaved int16 I,Q
- ``cbyte``: interleaved int8 I,Q
- ``ishort``: interleaved int16 I,Q (adapter Ishort_To_Complex)
- ``ibyte``: interleaved int8 I,Q (adapter Ibyte_To_Complex)
- ``short``: real int16 (I only, Q=0)
- ``byte``: real int8 (I only, Q=0)
- ``float``: real float32

Copied from ``gnss_sdr_tpu/sources/file_source.py``; only the import paths differ, and ``read_planar`` splits the
complex read with numpy instead of the native ingest library.
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np

# item_type -> (numpy dtype of the file, scalars per complex sample)
ITEM_TYPES: dict[str, tuple[np.dtype, int]] = {
    "gr_complex": (np.dtype(np.float32), 2),
    "cshort": (np.dtype(np.int16), 2),
    "cbyte": (np.dtype(np.int8), 2),
    "ishort": (np.dtype(np.int16), 2),
    "ibyte": (np.dtype(np.int8), 2),
    "short": (np.dtype(np.int16), 1),
    "byte": (np.dtype(np.int8), 1),
    "float": (np.dtype(np.float32), 1),
}


class FileSignalSource:
    """Streams complex64 sample blocks from a raw IF capture file.

    The ``samples`` limit and ``seconds_to_skip`` header skip mirror the
    reference valve/skip-head options (file_source_base.cc:70-120,
    gnss_sdr_valve.cc).
    """

    def __init__(
        self,
        filename: str | os.PathLike,
        sampling_frequency: float,
        item_type: str = "gr_complex",
        samples: int = 0,
        seconds_to_skip: float = 0.0,
        repeat: bool = False,
    ):
        if item_type not in ITEM_TYPES:
            raise ValueError(
                f"unknown item_type {item_type!r}; known: {sorted(ITEM_TYPES)}"
            )
        self.filename = str(filename)
        self.fs = float(sampling_frequency)
        self.item_type = item_type
        self.repeat = repeat
        dtype, per_sample = ITEM_TYPES[item_type]
        self._dtype = dtype
        self._per_sample = per_sample

        file_bytes = os.path.getsize(self.filename)
        total = file_bytes // (dtype.itemsize * per_sample)
        skip = int(seconds_to_skip * self.fs)
        self._skip_samples = min(skip, total)
        avail = total - self._skip_samples
        self.n_samples = min(avail, samples) if samples > 0 else avail

    # -- conversion -------------------------------------------------------
    def _to_complex(self, raw: np.ndarray) -> np.ndarray:
        if self._per_sample == 2:
            raw = raw.astype(np.float32)
            return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        return raw.astype(np.float32).astype(np.complex64)

    def read_planar(self, offset: int = 0, count: int | None = None):
        """Read directly to planar (re, im) float32."""
        x = self.read(offset, count)
        return (np.ascontiguousarray(x.real, np.float32),
                np.ascontiguousarray(x.imag, np.float32))

    # -- reading ----------------------------------------------------------
    def read(self, offset: int = 0, count: int | None = None) -> np.ndarray:
        """Read ``count`` complex samples starting at sample ``offset``."""
        if count is None:
            count = self.n_samples - offset
        count = max(0, min(count, self.n_samples - offset))
        start = (self._skip_samples + offset) * self._per_sample
        raw = np.fromfile(
            self.filename, dtype=self._dtype,
            count=count * self._per_sample, offset=start * self._dtype.itemsize,
        )
        return self._to_complex(raw)

    def blocks(self, block_samples: int, overlap: int = 0) -> Iterator[np.ndarray]:
        """Yield fixed-size blocks of ``block_samples + overlap`` samples.

        Consecutive blocks advance by ``block_samples``; the trailing
        ``overlap`` samples are repeated at the start of the next block
        (overlap-save for the tracking engine's cross-block PRN periods).
        The final partial block is zero-padded to full size.
        """
        pos = 0
        while pos < self.n_samples:
            chunk = self.read(pos, block_samples + overlap)
            if chunk.shape[0] < block_samples + overlap:
                pad = np.zeros(block_samples + overlap, dtype=np.complex64)
                pad[: chunk.shape[0]] = chunk
                chunk = pad
            yield chunk
            pos += block_samples
            if pos >= self.n_samples and self.repeat:
                pos = 0
