"""Packed sample-format unpackers (2-bit formats).

Vectorized counterparts of the reference's byte-serial unpacker blocks
(gnss-sdr/src/algorithms/signal_source/gnuradio_blocks/
unpack_2bit_samples.cc, unpack_byte_2bit_cpx_samples.cc): each byte carries
four signed 2-bit fields (two's complement, values -2..+1), least-significant
bits first, matching the C bit-field layout ``signed sample_0 : 2; ...`` on
little-endian hosts.

Copied from ``gnss_sdr_tpu/sources/unpack.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np


def _sign_extend_2bit(fields: np.ndarray) -> np.ndarray:
    """Interpret 2-bit fields (0..3) as two's complement (-2..1)."""
    return np.where(fields >= 2, fields.astype(np.int8) - 4, fields).astype(np.int8)


def unpack_2bit_samples(
    data: np.ndarray, big_endian_bytes: bool = False
) -> np.ndarray:
    """Unpack bytes into 4x signed 2-bit samples each.

    ``big_endian_bytes=False`` (default) emits the low-order field first,
    like the reference on a little-endian host; ``True`` reverses the field
    order within each byte.
    """
    b = np.asarray(data, dtype=np.uint8)
    fields = np.stack(
        [(b >> 0) & 0x3, (b >> 2) & 0x3, (b >> 4) & 0x3, (b >> 6) & 0x3], axis=1
    )
    if big_endian_bytes:
        fields = fields[:, ::-1]
    return _sign_extend_2bit(fields.reshape(-1))


def unpack_byte_2bit_cpx_samples(
    data: np.ndarray, reverse_interleaving: bool = False
) -> np.ndarray:
    """Unpack bytes of two 2-bit I/Q pairs into complex64 samples.

    Byte layout (lsb first): I0, Q0, I1, Q1 -- two complex samples per byte
    (unpack_byte_2bit_cpx_samples.cc). ``reverse_interleaving`` swaps the
    I/Q roles (Q first), as the reference option of the same name.
    """
    flat = unpack_2bit_samples(data).astype(np.float32)
    i = flat[0::2]
    q = flat[1::2]
    if reverse_interleaving:
        i, q = q, i
    return (i + 1j * q).astype(np.complex64)


def unpack_byte_2bit_real(raw: np.ndarray) -> np.ndarray:
    """Real 2-bit samples, 4 per byte, LSBs first -> float32
    (unpack_byte_2bit_samples.cc: the 2-bit bit-field sign-extends to
    -2..+1; the Nsr front-end format)."""
    b = np.asarray(raw, dtype=np.uint8)
    fields = np.empty((b.size, 4), dtype=np.uint8)
    for k in range(4):
        fields[:, k] = (b >> (2 * k)) & 3
    return _sign_extend_2bit(fields.reshape(-1)).astype(np.float32)


def unpack_byte_4bit(raw: np.ndarray) -> np.ndarray:
    """4-bit samples, 2 per byte, low nibble first -> int8 odd levels
    -15..+15 (unpack_byte_4bit_samples.cc: out = 2*v + 1 after sign
    extension)."""
    b = np.asarray(raw, dtype=np.uint8)
    lo = (b & 0x0F).astype(np.int16)
    hi = ((b >> 4) & 0x0F).astype(np.int16)
    nib = np.empty((b.size, 2), dtype=np.int16)
    nib[:, 0] = lo
    nib[:, 1] = hi
    nib = np.where(nib >= 8, nib - 16, nib)
    return (2 * nib.reshape(-1) + 1).astype(np.int8)


def unpack_intspir_1bit(raw: np.ndarray, channel: int = 1) -> np.ndarray:
    """SPIR 1-bit int32 words -> interleaved I/Q float32 at +-32767
    (unpack_intspir_1bit_samples.cc; ``channel`` selects the RF channel's
    bit pair inside each word)."""
    w = np.asarray(raw, dtype=np.int64)
    i_bit = (w >> ((channel - 1) * 2)) & 1
    q_bit = (w >> (2 * channel - 1)) & 1
    out = np.empty((w.size, 2), dtype=np.float32)
    out[:, 0] = np.where(i_bit == 1, 32767.0, -32767.0)
    out[:, 1] = np.where(q_bit == 1, 32767.0, -32767.0)
    return out.reshape(-1)


def unpack_spir_gss6450(raw: np.ndarray, adc_bits: int) -> np.ndarray:
    """SPIR GSS6450 int32 words -> complex64
    (unpack_spir_gss6450_samples.cc): samples are packed I-then-Q from
    the word's LSB end but emitted in REVERSED order (out[7-i]/out[3-i]),
    with two's-complement 2- or 4-bit components."""
    w = np.asarray(raw).astype(np.uint32)
    if adc_bits == 2:
        per, width, lim = 8, 2, 2
    elif adc_bits == 4:
        per, width, lim = 4, 4, 8
    else:
        raise ValueError("adc_bits must be 2 or 4")
    mask = (1 << width) - 1
    comps = np.empty((w.size, per, 2), dtype=np.int32)
    shift = 0
    for s in range(per):
        comps[:, s, 0] = (w >> shift) & mask
        shift += width
        comps[:, s, 1] = (w >> shift) & mask
        shift += width
    comps = np.where(comps >= lim, comps - 2 * lim, comps)
    comps = comps[:, ::-1, :]   # out[per-1-i] emission order
    return (comps[..., 0] + 1j * comps[..., 1]).astype(
        np.complex64).reshape(-1)
