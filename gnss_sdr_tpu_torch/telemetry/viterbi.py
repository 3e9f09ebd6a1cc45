"""Generic soft-input Viterbi decoder for rate-1/n convolutional codes.

Counterpart of the reference's Viterbi_Decoder
(gnss-sdr/src/algorithms/telemetry_decoder/libs/viterbi_decoder.cc)
and libswiftcnav's viterbi27: constraint length KK, rate 1/nn, generator
polynomials given as decimal numbers whose binary expansion taps the
shift register MSB-first (the reference's convention: Galileo I/NAV uses
(121, 91) decimal == (171, 133) octal, CCSDS).

Vectorized over the 2^(KK-1) trellis states in NumPy; telemetry decoding
is ~hundreds of bits/s per channel, so this runs on the host.

Copied from ``gnss_sdr_tpu/telemetry/viterbi.py``; only the import
paths differ.
"""

from __future__ import annotations

import numpy as np


class ViterbiDecoder:
    def __init__(self, kk: int = 7, nn: int = 2, g=(121, 91)):
        self.kk = kk
        self.nn = nn
        self.n_states = 1 << (kk - 1)
        # branch output bits for (state, input) pairs
        # register = [input, state bits (most recent first)]
        states = np.arange(self.n_states)
        outputs = np.zeros((2, self.n_states, nn), dtype=np.float64)
        for bit in (0, 1):
            reg = (bit << (kk - 1)) | states  # kk-bit register, input at MSB
            for j, poly in enumerate(g):
                taps = reg & poly
                outputs[bit, :, j] = np.array(
                    [bin(v).count("1") & 1 for v in taps], dtype=np.float64)
        # map coded bit {0,1} -> expected soft sign {+1,-1}: bit 1 -> -1
        self._expect = 1.0 - 2.0 * outputs  # [input, state, nn]
        # next state: shift input into the register
        self._next = ((states >> 1)[None, :]
                      | (np.array([0, 1])[:, None] << (kk - 2))).astype(int)

    def decode(self, soft: np.ndarray, terminated: bool = True) -> np.ndarray:
        """Decode soft symbols (+1 = coded bit 0, -1 = coded bit 1).

        ``soft`` has length nn * nbits. With ``terminated`` the encoder is
        assumed flushed to state 0 (the reference decodes fixed-length
        blocks with tail bits); otherwise the best end state wins.
        Returns the decoded information bits (including any tail).
        """
        soft = np.asarray(soft, dtype=np.float64)
        nbits = soft.shape[0] // self.nn
        n_states = self.n_states
        metrics = np.full(n_states, -1e18)
        metrics[0] = 0.0
        decisions = np.zeros((nbits, n_states), dtype=np.uint8)

        for t in range(nbits):
            sym = soft[t * self.nn:(t + 1) * self.nn]
            # branch metric: correlation of expected signs with soft input
            bm = self._expect @ sym  # [input, state]
            # add-compare-select per next state: predecessors of ns under
            # its producing input bit b_in (= MSB of ns) are
            # {base, base+1} with base = (ns & ~MSB) << 1
            mask = n_states - 1
            ns = np.arange(n_states)
            base = (ns & ~(1 << (self.kk - 2))) << 1
            b_in = (ns >> (self.kk - 2)) & 1
            s_a = base & mask
            s_b = (base | 1) & mask
            m_a = metrics[s_a] + bm[b_in, s_a]
            m_b = metrics[s_b] + bm[b_in, s_b]
            take_b = m_b > m_a
            decisions[t] = take_b.astype(np.uint8)
            metrics = np.where(take_b, m_b, m_a)

        # traceback
        state = 0 if terminated else int(np.argmax(metrics))
        bits = np.zeros(nbits, dtype=np.int64)
        mask = n_states - 1
        for t in range(nbits - 1, -1, -1):
            bits[t] = (state >> (self.kk - 2)) & 1
            base = (state & ~(1 << (self.kk - 2))) << 1
            state = (base | int(decisions[t, state])) & mask
        return bits


def encode_conv(bits: np.ndarray, kk: int = 7, g=(121, 91)) -> np.ndarray:
    """Rate-1/n convolutional encoder (test oracle / simulator side).

    Shift-register convention matches :class:`ViterbiDecoder`. Returns
    coded bits (0/1), nn per input bit. Flush with kk-1 tail zeros to
    terminate (append them to ``bits`` yourself).
    """
    reg = 0
    kk_mask = (1 << kk) - 1
    out = []
    for b in bits:
        reg = ((int(b) << (kk - 1)) | (reg >> 1)) & kk_mask
        for poly in g:
            out.append(bin(reg & poly).count("1") & 1)
    return np.array(out, dtype=np.int64)
