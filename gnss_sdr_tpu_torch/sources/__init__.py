"""Sample ingest: file signal sources and format unpackers (L4 signal_source).

Host-side loaders that normalize every supported capture format to
``complex64`` baseband blocks for the device pipeline, covering the roles of
the reference's File_Signal_Source + data-type adapters + bit unpackers
(gnss-sdr src/algorithms/signal_source/adapters/file_signal_source.cc,
src/algorithms/data_type_adapter/adapters/*,
src/algorithms/signal_source/gnuradio_blocks/unpack_*.cc).

Counterpart of ``gnss_sdr_tpu/sources/__init__.py`` with the same exports.
"""

from gnss_sdr_tpu_torch.sources.labsat import LabsatSignalSource  # noqa: F401
from gnss_sdr_tpu_torch.sources.file_source import FileSignalSource, ITEM_TYPES
from gnss_sdr_tpu_torch.sources.live import (
    FifoSignalSource,
    FileTimestampSignalSource,
    TimeTag,
    UdpSignalSource,
)
from gnss_sdr_tpu_torch.sources.unpack import (
    unpack_2bit_samples,
    unpack_byte_2bit_cpx_samples,
)

__all__ = [
    "FileSignalSource",
    "FifoSignalSource",
    "FileTimestampSignalSource",
    "TimeTag",
    "UdpSignalSource",
    "ITEM_TYPES",
    "unpack_2bit_samples",
    "unpack_byte_2bit_cpx_samples",
]
