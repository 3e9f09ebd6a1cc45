"""LabSat 2/3 container file source.

Counterpart of the reference's ``labsat23_source``
(gnss-sdr src/algorithms/signal_source/gnuradio_blocks/
labsat23_source.cc): parses the LS2/LS3 container header (8-byte zero
preamble, "LS2"/"LS3" magic + sub-version, little-endian header length,
section 2 with reference-clock / bits-per-sample / channel-selector /
quantization / per-channel constellation fields, :137-356) and decodes
the single-channel payload (2 bits per complex sample: 8 samples per
int16, I/Q sign bits mapped to +-1; 4 bits: 4 samples per int16,
sign+magnitude mapped to +-1/+-2 — decode_samples_one_channel,
:360-433). Dual-channel files and the LS3W wideband (.ini-described)
variant are rejected exactly like the reference's non-FPGA path.

Copied from ``gnss_sdr_tpu/sources/labsat.py``; only the reference path
differs (it imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LabsatHeader:
    version: int                 # 2 or 3
    sub_version: int
    header_bytes: int
    ref_clock: int               # 0 OCXO / 1 TCXO / 2 ext10M / 3 ext16.386M
    bits_per_sample: int         # 2 or 4
    channel_selector: int        # 1/3 = channel A, 2/4 = channel B
    quantization: int
    channel_a_constellation: int  # 0 GPS / 1 GLONASS / 2 BDS
    channel_b_constellation: int  # 255 = absent


def parse_labsat_header(block: bytes) -> LabsatHeader:
    """Parse the leading container header (labsat23_source.cc:137-356)."""
    if len(block) < 32:
        raise ValueError("LabSat header: file too short")
    if any(block[i] != 0 for i in range(8)):
        raise ValueError("LabSat header: preamble not detected")
    magic = block[8:11]
    if magic == b"LS2":
        version = 2
    elif magic == b"LS3":
        version = 3
    else:
        raise ValueError("LabSat header: version magic not detected")
    sub_version = block[11]
    header_bytes = int.from_bytes(block[12:16], "little")
    section_id = int.from_bytes(block[16:18], "little")
    # 4 bytes of section length follow (unused, like the reference)
    if section_id != 2:
        raise ValueError("LabSat header: section 2 is not available")
    b = 22
    ref_clock = block[b]
    bits_per_sample = block[b + 1]
    if bits_per_sample not in (2, 4):
        raise ValueError(
            f"LabSat: unknown bits per sample ID {bits_per_sample}")
    channel_selector = block[b + 2]
    if channel_selector == 0:
        raise ValueError(
            "LabSat: dual-channel files are not supported "
            f"for LabSat version {version}")
    if channel_selector > 4:
        raise ValueError(
            f"LabSat: unknown channel selection ID {channel_selector}")
    quantization = block[b + 3]
    return LabsatHeader(
        version=version, sub_version=sub_version,
        header_bytes=header_bytes, ref_clock=ref_clock,
        bits_per_sample=bits_per_sample,
        channel_selector=channel_selector, quantization=quantization,
        channel_a_constellation=block[b + 4],
        channel_b_constellation=block[b + 5])


def decode_labsat_payload(words: np.ndarray,
                          bits_per_sample: int) -> np.ndarray:
    """int16 payload words -> complex64 samples
    (decode_samples_one_channel, labsat23_source.cc:360-433)."""
    v = np.asarray(words).astype(np.int16).view(np.uint16).astype(np.uint32)
    if bits_per_sample == 2:
        # 8 samples per word: bit (15-2i) = I sign, (14-2i) = Q sign;
        # out = 2*bit - 1
        i_bits = np.stack([(v >> (15 - 2 * i)) & 1 for i in range(8)],
                          axis=1)
        q_bits = np.stack([(v >> (14 - 2 * i)) & 1 for i in range(8)],
                          axis=1)
        out = (2.0 * i_bits - 1.0) + 1j * (2.0 * q_bits - 1.0)
        return out.reshape(-1).astype(np.complex64)
    if bits_per_sample == 4:
        # 4 samples per word: (sign, mag) -> {00:+1, 01:+2, 10:-2, 11:-1}
        def comp(sign_bit, mag_bit):
            s = (v >> sign_bit) & 1
            m = (v >> mag_bit) & 1
            return np.where(s == 1, np.where(m == 1, -1.0, -2.0),
                            np.where(m == 1, 2.0, 1.0))

        i_vals = np.stack([comp(15 - 4 * i, 13 - 4 * i)
                           for i in range(4)], axis=1)
        q_vals = np.stack([comp(14 - 4 * i, 12 - 4 * i)
                           for i in range(4)], axis=1)
        return (i_vals + 1j * q_vals).reshape(-1).astype(np.complex64)
    raise ValueError(f"bits_per_sample must be 2 or 4, got {bits_per_sample}")


class LabsatSignalSource:
    """File source over a LabSat 2/3 container (Labsat_Signal_Source)."""

    def __init__(self, filename: str, sampling_frequency: float = 16.368e6):
        self.filename = filename
        self.fs = float(sampling_frequency)
        self.item_type = "gr_complex"
        with open(filename, "rb") as fh:
            head = fh.read(1024)
        self.header = parse_labsat_header(head)
        self._payload_offset = self.header.header_bytes
        import os

        payload_bytes = os.path.getsize(filename) - self._payload_offset
        self._samples_per_word = 8 if self.header.bits_per_sample == 2 else 4
        self.n_samples = (payload_bytes // 2) * self._samples_per_word

    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        """Decoded complex64 samples [start : start+count]."""
        if count is None:
            count = self.n_samples - start
        spw = self._samples_per_word
        w0 = start // spw
        w1 = (start + count + spw - 1) // spw
        with open(self.filename, "rb") as fh:
            fh.seek(self._payload_offset + 2 * w0)
            raw = fh.read(2 * (w1 - w0))
        words = np.frombuffer(raw, dtype="<i2")
        out = decode_labsat_payload(words, self.header.bits_per_sample)
        lo = start - w0 * spw
        return out[lo:lo + count]


def write_labsat_file(path: str, samples: np.ndarray,
                      bits_per_sample: int = 2, version: int = 3,
                      channel_selector: int = 1,
                      constellation: int = 0) -> None:
    """Synthesize a LabSat container (test/simulation source): quantizes
    complex samples to the container's 1-bit (+-1) or 2-bit (+-1/+-2)
    I/Q levels and packs them with a valid header."""
    header_bytes = 64
    head = bytearray(header_bytes)
    head[8:11] = b"LS2" if version == 2 else b"LS3"
    head[11] = 1                                   # sub version
    head[12:16] = int(header_bytes).to_bytes(4, "little")
    head[16:18] = (2).to_bytes(2, "little")        # section id
    head[18:22] = (44).to_bytes(4, "little")       # section length
    head[22] = 1                                   # TCXO
    head[23] = bits_per_sample
    head[24] = channel_selector
    head[25] = bits_per_sample // 2
    head[26] = constellation
    head[27] = 255                                 # no channel B
    x = np.asarray(samples)
    if bits_per_sample == 2:
        spw = 8
        n = (len(x) // spw) * spw
        i_bits = (x.real[:n] >= 0).astype(np.uint32)
        q_bits = (x.imag[:n] >= 0).astype(np.uint32)
        words = np.zeros(n // spw, dtype=np.uint32)
        for i in range(spw):
            words |= i_bits[i::spw] << (15 - 2 * i)
            words |= q_bits[i::spw] << (14 - 2 * i)
    else:
        spw = 4
        n = (len(x) // spw) * spw

        def enc(vals):
            # levels {+1:00, +2:01, -2:10, -1:11}
            sign = (vals < 0).astype(np.uint32)
            big = (np.abs(vals) >= 1.5).astype(np.uint32)
            mag = np.where(sign == 1, 1 - big, big).astype(np.uint32)
            return sign, mag

        si, mi = enc(x.real[:n])
        sq, mq = enc(x.imag[:n])
        words = np.zeros(n // spw, dtype=np.uint32)
        for i in range(spw):
            words |= si[i::spw] << (15 - 4 * i)
            words |= sq[i::spw] << (14 - 4 * i)
            words |= mi[i::spw] << (13 - 4 * i)
            words |= mq[i::spw] << (12 - 4 * i)
    with open(path, "wb") as fh:
        fh.write(bytes(head))
        fh.write(words.astype(np.uint16).view(np.int16).astype("<i2")
                 .tobytes())
