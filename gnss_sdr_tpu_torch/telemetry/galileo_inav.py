"""Galileo E1-B I/NAV navigation-message decoding.

Counterpart of the reference's Galileo telemetry chain
(gnss-sdr/src/algorithms/telemetry_decoder/gnuradio_blocks/
galileo_telemetry_decoder_gs.cc and
src/core/system_parameters/galileo_inav_message.cc):

- 250 symbols/s page parts: 10-symbol sync pattern + 240 coded symbols;
- 8x30 block deinterleaver (out[c*8+r] = in[r*30+c], :340-349);
- rate-1/2 K=7 Viterbi with the G2 NOT gate (every second symbol negated,
  :359-366), polynomials (121, 91) decimal = (171, 133) octal;
- even/odd page-part pairing with CRC-24Q over the joined 196 bits
  (split_page semantics);
- word types 0-5 parsed into ephemeris/clock/GST fields (Galileo OS SIS
  ICD 4.3.5), feeding the same Kepler evaluator as GPS.

An encoder (for the simulator/tests) inverts every stage.

Copied from ``gnss_sdr_tpu/telemetry/galileo_inav.py``; only the import
paths differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.telemetry.viterbi import (ViterbiDecoder,
                                                  encode_conv)

SYNC_PATTERN = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.int64)
PART_SYMBOLS = 250
CODED_SYMBOLS = 240
PART_BITS = 120  # after Viterbi (incl. 6 tail bits)
ROWS, COLS = 8, 30
CRC24_POLY = 0x1864CFB
PI = np.pi


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over a bit array (MSB-first), as used by Galileo I/NAV
    (generator 0x1864CFB; the register keeps the low 24 bits)."""
    poly24 = CRC24_POLY & 0xFFFFFF  # drop the x^24 term
    reg = 0
    for b in np.concatenate([np.asarray(bits, dtype=np.int64),
                             np.zeros(24, dtype=np.int64)]):
        top = (reg >> 23) & 1
        reg = ((reg << 1) | int(b)) & 0xFFFFFF
        if top:
            reg ^= poly24
    return reg


def interleave(bits_or_syms: np.ndarray) -> np.ndarray:
    """Interleaver (encoder side): in[c*8+r] -> out[r*30+c]."""
    x = np.asarray(bits_or_syms)
    return x.reshape(COLS, ROWS).T.reshape(-1)


def deinterleave(symbols: np.ndarray) -> np.ndarray:
    """Deinterleaver: out[c*8+r] = in[r*30+c] (:340-349)."""
    x = np.asarray(symbols)
    return x.reshape(ROWS, COLS).T.reshape(-1)


def encode_page_part(bits120: np.ndarray) -> np.ndarray:
    """120 bits -> 250 +-1 symbols (conv encode, G2 NOT, interleave, sync).

    The 120 bits must already end with 6 zero tail bits.
    """
    coded = encode_conv(np.asarray(bits120, dtype=np.int64))  # 240 bits
    coded = coded.reshape(-1, 2)
    coded[:, 1] ^= 1  # G2 NOT gate
    coded = interleave(coded.reshape(-1))
    part = np.concatenate([SYNC_PATTERN, coded])
    return np.where(part == 1, -1.0, 1.0)  # bit 1 -> -1 symbol


def decode_page_part(symbols250: np.ndarray,
                     decoder: ViterbiDecoder) -> np.ndarray:
    """250 soft symbols (sync first) -> 120 decoded bits."""
    soft = np.asarray(symbols250, dtype=np.float64)[10:]
    soft = deinterleave(soft)
    # undo G2 NOT: negate every 2nd symbol (:359-366)
    soft = soft.copy()
    soft[1::2] = -soft[1::2]
    # our symbol convention: bit 1 -> -1, so feed soft directly (decoder
    # expects +1 == bit 0)
    return decoder.decode(soft, terminated=True)


# ---------------------------------------------------------------------------
# Page pairing + CRC (split_page semantics)
# ---------------------------------------------------------------------------


def check_page_pair(even120: np.ndarray, odd120: np.ndarray):
    """CRC-check an even/odd page-part pair.

    CRC-24Q covers even bits 0..111 (without the 6+2 tail/spare... per ICD:
    even part bits 0..113) concatenated with odd bits 0..81; the CRC field
    is odd bits 82..105. Returns (ok, data_bits[128]) where data = even
    data field (112 bits incl. type) + odd data continuation (16 bits).
    """
    even120 = np.asarray(even120, dtype=np.int64)
    odd120 = np.asarray(odd120, dtype=np.int64)
    if even120[0] != 0 or odd120[0] != 1:
        return False, None
    msg = np.concatenate([even120[:114], odd120[:82]])
    crc_bits = odd120[82:106]
    crc_val = 0
    for b in crc_bits:
        crc_val = (crc_val << 1) | int(b)
    ok = crc24q(msg) == crc_val
    data = np.concatenate([even120[2:114], odd120[2:18]])
    return ok, data


def build_page_pair(data128: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of check_page_pair: 128 data bits -> (even120, odd120)."""
    data128 = np.asarray(data128, dtype=np.int64)
    even = np.zeros(120, dtype=np.int64)
    odd = np.zeros(120, dtype=np.int64)
    even[0] = 0  # even/odd flag
    even[1] = 0  # page type: nominal
    even[2:114] = data128[:112]
    odd[0] = 1
    odd[1] = 0
    odd[2:18] = data128[112:]
    msg = np.concatenate([even[:114], odd[:82]])
    crc = crc24q(msg)
    for i in range(24):
        odd[82 + i] = (crc >> (23 - i)) & 1
    # tails (last 6 bits of each part) stay zero
    return even, odd


# ---------------------------------------------------------------------------
# Word parsing (ICD 4.3.5) — types 0-5
# ---------------------------------------------------------------------------


def _u(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _s(bits) -> int:
    v = _u(bits)
    if bits[0] == 1:
        v -= 1 << len(bits)
    return v


def parse_inav_word(data128: np.ndarray) -> dict:
    """Parse one I/NAV word (128 data bits, type in bits 0..5)."""
    d = np.asarray(data128, dtype=np.int64)
    wtype = _u(d[0:6])
    out: dict = {"word_type": wtype}
    if wtype == 1:
        out["iod_nav"] = _u(d[6:16])
        out["toe_s"] = _u(d[16:30]) * 60.0
        out["m0_rad"] = _s(d[30:62]) * 2.0**-31 * PI
        out["ecc"] = _u(d[62:94]) * 2.0**-33
        out["sqrt_a"] = _u(d[94:126]) * 2.0**-19
    elif wtype == 2:
        out["iod_nav"] = _u(d[6:16])
        out["omega0_rad"] = _s(d[16:48]) * 2.0**-31 * PI
        out["i0_rad"] = _s(d[48:80]) * 2.0**-31 * PI
        out["omega_rad"] = _s(d[80:112]) * 2.0**-31 * PI
        out["idot_rad_s"] = _s(d[112:126]) * 2.0**-43 * PI
    elif wtype == 3:
        out["iod_nav"] = _u(d[6:16])
        out["omega_dot_rad_s"] = _s(d[16:40]) * 2.0**-43 * PI
        out["delta_n_rad_s"] = _s(d[40:56]) * 2.0**-43 * PI
        out["cuc_rad"] = _s(d[56:72]) * 2.0**-29
        out["cus_rad"] = _s(d[72:88]) * 2.0**-29
        out["crc_m"] = _s(d[88:104]) * 2.0**-5
        out["crs_m"] = _s(d[104:120]) * 2.0**-5
        out["sisa"] = _u(d[120:128])
    elif wtype == 4:
        out["iod_nav"] = _u(d[6:16])
        out["svid"] = _u(d[16:22])
        out["cic_rad"] = _s(d[22:38]) * 2.0**-29
        out["cis_rad"] = _s(d[38:54]) * 2.0**-29
        out["toc_s"] = _u(d[54:68]) * 60.0
        out["af0"] = _s(d[68:99]) * 2.0**-34
        out["af1"] = _s(d[99:120]) * 2.0**-46
        out["af2"] = _s(d[120:126]) * 2.0**-59
    elif wtype == 5:
        # iono, BGD, health + GST
        out["ai0"] = _u(d[6:17]) * 2.0**-2
        out["ai1"] = _s(d[17:28]) * 2.0**-8
        out["ai2"] = _s(d[28:42]) * 2.0**-15
        out["bgd_e1e5a_s"] = _s(d[47:57]) * 2.0**-32
        out["bgd_e1e5b_s"] = _s(d[57:67]) * 2.0**-32
        out["week_number"] = _u(d[73:85])
        out["tow_s"] = _u(d[85:105])
    elif wtype == 6:
        # GST-UTC conversion (Galileo_INAV.h:144-155)
        out["a0_s"] = _s(d[6:38]) * 2.0**-30
        out["a1_s_s"] = _s(d[38:62]) * 2.0**-50
        out["delta_t_ls_s"] = _s(d[62:70])
        out["t0t_s"] = _u(d[70:78]) * 3600.0
        out["wn_ot"] = _u(d[78:86])
        out["wn_lsf"] = _u(d[86:94])
        out["dn"] = _u(d[94:97])
        out["delta_t_lsf_s"] = _s(d[97:105])
        out["tow_s"] = _u(d[105:125])
    elif wtype == 7:
        # almanac 1/3 for SVID1 (Galileo_INAV.h:156-176)
        out["iod_a"] = _u(d[6:10])
        out["wn_a"] = _u(d[10:12])
        out["t0a_s"] = _u(d[12:22]) * 600.0
        out["svid1"] = _u(d[22:28])
        out["delta_sqrt_a"] = _s(d[28:41]) * 2.0**-9
        out["ecc"] = _u(d[41:52]) * 2.0**-16
        out["omega_rad"] = _s(d[52:68]) * 2.0**-15 * PI
        out["delta_i_rad"] = _s(d[68:79]) * 2.0**-14 * PI
        out["omega0_rad"] = _s(d[79:95]) * 2.0**-15 * PI
        out["omega_dot_rad_s"] = _s(d[95:106]) * 2.0**-33 * PI
        out["m0_rad"] = _s(d[106:122]) * 2.0**-15 * PI
    elif wtype == 8:
        # almanac 2/3: SVID1 clock + SVID2 orbit (Galileo_INAV.h:178-199)
        out["iod_a"] = _u(d[6:10])
        out["af0_s"] = _s(d[10:26]) * 2.0**-19
        out["af1_s_s"] = _s(d[26:39]) * 2.0**-38
        out["e5b_hs"] = _u(d[39:41])
        out["e1b_hs"] = _u(d[41:43])
        out["svid2"] = _u(d[43:49])
        out["delta_sqrt_a"] = _s(d[49:62]) * 2.0**-9
        out["ecc"] = _u(d[62:73]) * 2.0**-16
        out["omega_rad"] = _s(d[73:89]) * 2.0**-15 * PI
        out["delta_i_rad"] = _s(d[89:100]) * 2.0**-14 * PI
        out["omega0_rad"] = _s(d[100:116]) * 2.0**-15 * PI
        out["omega_dot_rad_s"] = _s(d[116:127]) * 2.0**-33 * PI
    elif wtype == 9:
        # almanac 3/3: SVID2 clock + SVID3 orbit start (Galileo_INAV.h:201-223)
        out["iod_a"] = _u(d[6:10])
        out["wn_a"] = _u(d[10:12])
        out["t0a_s"] = _u(d[12:22]) * 600.0
        out["m0_rad"] = _s(d[22:38]) * 2.0**-15 * PI
        out["af0_s"] = _s(d[38:54]) * 2.0**-19
        out["af1_s_s"] = _s(d[54:67]) * 2.0**-38
        out["e5b_hs"] = _u(d[67:69])
        out["e1b_hs"] = _u(d[69:71])
        out["svid3"] = _u(d[71:77])
        out["delta_sqrt_a"] = _s(d[77:90]) * 2.0**-9
        out["ecc"] = _u(d[90:101]) * 2.0**-16
        out["omega_rad"] = _s(d[101:117]) * 2.0**-15 * PI
        out["delta_i_rad"] = _s(d[117:128]) * 2.0**-14 * PI
    elif wtype == 10:
        # almanac end + GST-GPS conversion (Galileo_INAV.h:225-248)
        out["iod_a"] = _u(d[6:10])
        out["omega0_rad"] = _s(d[10:26]) * 2.0**-15 * PI
        out["omega_dot_rad_s"] = _s(d[26:37]) * 2.0**-33 * PI
        out["m0_rad"] = _s(d[37:53]) * 2.0**-15 * PI
        out["af0_s"] = _s(d[53:69]) * 2.0**-19
        out["af1_s_s"] = _s(d[69:82]) * 2.0**-38
        out["e5b_hs"] = _u(d[82:84])
        out["e1b_hs"] = _u(d[84:86])
        out["a0g_s"] = _s(d[86:102]) * 2.0**-35
        out["a1g_s_s"] = _s(d[102:114]) * 2.0**-51
        out["t0g_s"] = _u(d[114:122]) * 3600.0
        out["wn0g"] = _u(d[122:128])
    elif wtype == 16:
        # reduced CED (Galileo_INAV.h:250-265)
        out["delta_a_red_m"] = _s(d[6:11]) * 2.0**8
        out["ex_red"] = _s(d[11:24]) * 2.0**-22
        out["ey_red"] = _s(d[24:37]) * 2.0**-22
        out["delta_i0_red_rad"] = _s(d[37:54]) * 2.0**-22 * PI
        out["omega0_red_rad"] = _s(d[54:77]) * 2.0**-22 * PI
        out["lambda0_red_rad"] = _s(d[77:100]) * 2.0**-22 * PI
        out["af0_red_s"] = _s(d[100:122]) * 2.0**-26
        out["af1_red_s_s"] = _s(d[122:128]) * 2.0**-35
    elif wtype in (17, 18, 19, 20):
        # FEC2 Reed-Solomon parity for CED (Galileo_INAV.h:266-275):
        # gamma octet 0 at bits 6..14, IODnav LSBs at 14..16, 14 more octets
        out["iodnav_lsbs"] = _u(d[14:16])
        octets = [_u(d[6:14])]
        for i in range(14):
            octets.append(_u(d[16 + 8 * i:24 + 8 * i]))
        out["rs_parity_octets"] = octets
    elif wtype == 0:
        out["time_flags"] = _u(d[6:8])
        out["week_number"] = _u(d[96:108])
        out["tow_s"] = _u(d[108:128])
    return out


def build_inav_word(fields: dict) -> np.ndarray:
    """Encode one I/NAV word (inverse of parse, for simulation)."""
    d = np.zeros(128, dtype=np.int64)

    def put_u(lo, hi, value, scale=1.0):
        n = hi - lo
        iv = int(round(value / scale))
        assert 0 <= iv < (1 << n), (lo, hi, value)
        for i in range(n):
            d[lo + i] = (iv >> (n - 1 - i)) & 1

    def put_s(lo, hi, value, scale=1.0):
        n = hi - lo
        iv = int(round(value / scale))
        assert -(1 << (n - 1)) <= iv < (1 << (n - 1))
        if iv < 0:
            iv += 1 << n
        for i in range(n):
            d[lo + i] = (iv >> (n - 1 - i)) & 1

    wtype = fields["word_type"]
    put_u(0, 6, wtype)
    if wtype == 1:
        put_u(6, 16, fields["iod_nav"])
        put_u(16, 30, fields["toe_s"], 60.0)
        put_s(30, 62, fields["m0_rad"] / PI, 2.0**-31)
        put_u(62, 94, fields["ecc"], 2.0**-33)
        put_u(94, 126, fields["sqrt_a"], 2.0**-19)
    elif wtype == 2:
        put_u(6, 16, fields["iod_nav"])
        put_s(16, 48, fields["omega0_rad"] / PI, 2.0**-31)
        put_s(48, 80, fields["i0_rad"] / PI, 2.0**-31)
        put_s(80, 112, fields["omega_rad"] / PI, 2.0**-31)
        put_s(112, 126, fields["idot_rad_s"] / PI, 2.0**-43)
    elif wtype == 3:
        put_u(6, 16, fields["iod_nav"])
        put_s(16, 40, fields["omega_dot_rad_s"] / PI, 2.0**-43)
        put_s(40, 56, fields["delta_n_rad_s"] / PI, 2.0**-43)
        put_s(56, 72, fields["cuc_rad"], 2.0**-29)
        put_s(72, 88, fields["cus_rad"], 2.0**-29)
        put_s(88, 104, fields["crc_m"], 2.0**-5)
        put_s(104, 120, fields["crs_m"], 2.0**-5)
        put_u(120, 128, fields.get("sisa", 107))
    elif wtype == 4:
        put_u(6, 16, fields["iod_nav"])
        put_u(16, 22, fields.get("svid", 1))
        put_s(22, 38, fields["cic_rad"], 2.0**-29)
        put_s(38, 54, fields["cis_rad"], 2.0**-29)
        put_u(54, 68, fields["toc_s"], 60.0)
        put_s(68, 99, fields["af0"], 2.0**-34)
        put_s(99, 120, fields["af1"], 2.0**-46)
        put_s(120, 126, fields["af2"], 2.0**-59)
    elif wtype == 5:
        put_u(6, 17, fields.get("ai0", 0.0), 2.0**-2)
        put_s(17, 28, fields.get("ai1", 0.0), 2.0**-8)
        put_s(28, 42, fields.get("ai2", 0.0), 2.0**-15)
        put_s(47, 57, fields.get("bgd_e1e5a_s", 0.0), 2.0**-32)
        put_s(57, 67, fields.get("bgd_e1e5b_s", 0.0), 2.0**-32)
        put_u(73, 85, fields["week_number"])
        put_u(85, 105, fields["tow_s"])
    elif wtype == 6:
        put_s(6, 38, fields.get("a0_s", 0.0), 2.0**-30)
        put_s(38, 62, fields.get("a1_s_s", 0.0), 2.0**-50)
        put_s(62, 70, fields.get("delta_t_ls_s", 18))
        put_u(70, 78, fields.get("t0t_s", 0.0), 3600.0)
        put_u(78, 86, fields.get("wn_ot", 0))
        put_u(86, 94, fields.get("wn_lsf", 0))
        put_u(94, 97, fields.get("dn", 0))
        put_s(97, 105, fields.get("delta_t_lsf_s", 18))
        put_u(105, 125, fields.get("tow_s", 0))
    elif wtype == 7:
        put_u(6, 10, fields.get("iod_a", 0))
        put_u(10, 12, fields.get("wn_a", 0))
        put_u(12, 22, fields.get("t0a_s", 0.0), 600.0)
        put_u(22, 28, fields.get("svid1", 1))
        put_s(28, 41, fields.get("delta_sqrt_a", 0.0), 2.0**-9)
        put_u(41, 52, fields.get("ecc", 0.0), 2.0**-16)
        put_s(52, 68, fields.get("omega_rad", 0.0) / PI, 2.0**-15)
        put_s(68, 79, fields.get("delta_i_rad", 0.0) / PI, 2.0**-14)
        put_s(79, 95, fields.get("omega0_rad", 0.0) / PI, 2.0**-15)
        put_s(95, 106, fields.get("omega_dot_rad_s", 0.0) / PI, 2.0**-33)
        put_s(106, 122, fields.get("m0_rad", 0.0) / PI, 2.0**-15)
    elif wtype == 8:
        put_u(6, 10, fields.get("iod_a", 0))
        put_s(10, 26, fields.get("af0_s", 0.0), 2.0**-19)
        put_s(26, 39, fields.get("af1_s_s", 0.0), 2.0**-38)
        put_u(39, 41, fields.get("e5b_hs", 0))
        put_u(41, 43, fields.get("e1b_hs", 0))
        put_u(43, 49, fields.get("svid2", 2))
        put_s(49, 62, fields.get("delta_sqrt_a", 0.0), 2.0**-9)
        put_u(62, 73, fields.get("ecc", 0.0), 2.0**-16)
        put_s(73, 89, fields.get("omega_rad", 0.0) / PI, 2.0**-15)
        put_s(89, 100, fields.get("delta_i_rad", 0.0) / PI, 2.0**-14)
        put_s(100, 116, fields.get("omega0_rad", 0.0) / PI, 2.0**-15)
        put_s(116, 127, fields.get("omega_dot_rad_s", 0.0) / PI, 2.0**-33)
    elif wtype == 9:
        put_u(6, 10, fields.get("iod_a", 0))
        put_u(10, 12, fields.get("wn_a", 0))
        put_u(12, 22, fields.get("t0a_s", 0.0), 600.0)
        put_s(22, 38, fields.get("m0_rad", 0.0) / PI, 2.0**-15)
        put_s(38, 54, fields.get("af0_s", 0.0), 2.0**-19)
        put_s(54, 67, fields.get("af1_s_s", 0.0), 2.0**-38)
        put_u(67, 69, fields.get("e5b_hs", 0))
        put_u(69, 71, fields.get("e1b_hs", 0))
        put_u(71, 77, fields.get("svid3", 3))
        put_s(77, 90, fields.get("delta_sqrt_a", 0.0), 2.0**-9)
        put_u(90, 101, fields.get("ecc", 0.0), 2.0**-16)
        put_s(101, 117, fields.get("omega_rad", 0.0) / PI, 2.0**-15)
        put_s(117, 128, fields.get("delta_i_rad", 0.0) / PI, 2.0**-14)
    elif wtype == 10:
        put_u(6, 10, fields.get("iod_a", 0))
        put_s(10, 26, fields.get("omega0_rad", 0.0) / PI, 2.0**-15)
        put_s(26, 37, fields.get("omega_dot_rad_s", 0.0) / PI, 2.0**-33)
        put_s(37, 53, fields.get("m0_rad", 0.0) / PI, 2.0**-15)
        put_s(53, 69, fields.get("af0_s", 0.0), 2.0**-19)
        put_s(69, 82, fields.get("af1_s_s", 0.0), 2.0**-38)
        put_u(82, 84, fields.get("e5b_hs", 0))
        put_u(84, 86, fields.get("e1b_hs", 0))
        put_s(86, 102, fields.get("a0g_s", 0.0), 2.0**-35)
        put_s(102, 114, fields.get("a1g_s_s", 0.0), 2.0**-51)
        put_u(114, 122, fields.get("t0g_s", 0.0), 3600.0)
        put_u(122, 128, fields.get("wn0g", 0))
    elif wtype == 16:
        put_s(6, 11, fields.get("delta_a_red_m", 0.0), 2.0**8)
        put_s(11, 24, fields.get("ex_red", 0.0), 2.0**-22)
        put_s(24, 37, fields.get("ey_red", 0.0), 2.0**-22)
        put_s(37, 54, fields.get("delta_i0_red_rad", 0.0) / PI, 2.0**-22)
        put_s(54, 77, fields.get("omega0_red_rad", 0.0) / PI, 2.0**-22)
        put_s(77, 100, fields.get("lambda0_red_rad", 0.0) / PI, 2.0**-22)
        put_s(100, 122, fields.get("af0_red_s", 0.0), 2.0**-26)
        put_s(122, 128, fields.get("af1_red_s_s", 0.0), 2.0**-35)
    elif wtype in (17, 18, 19, 20):
        octets = fields["rs_parity_octets"]
        assert len(octets) == 15
        put_u(6, 14, octets[0])
        put_u(14, 16, fields.get("iodnav_lsbs", 0))
        for i in range(14):
            put_u(16 + 8 * i, 24 + 8 * i, octets[i + 1])
    elif wtype == 0:
        put_u(6, 8, fields.get("time_flags", 2))
        put_u(96, 108, fields["week_number"])
        put_u(108, 128, fields["tow_s"])
    return d


# ---------------------------------------------------------------------------
# Streaming decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InavWordUpdate:
    word_type: int
    fields: dict
    sample_stamp: int


class GalileoInavDecoder:
    """Per-channel streaming I/NAV decoder (E1-B, one symbol per 4 ms)."""

    #: periods (4 ms) without a valid page before telemetry_failed
    #: (galileo_telemetry_decoder_gs watchdog parity)
    WATCHDOG_PERIODS = 500 * 20

    def __init__(self, crc_stats=None, watchdog_periods: int | None = None):
        self.crc_stats = crc_stats   # optional TlmCrcStats (CRC-24Q outcomes)
        self.watchdog_periods = (self.WATCHDOG_PERIODS
                                 if watchdog_periods is None
                                 else int(watchdog_periods))
        self._n_fed = 0
        self._last_valid = 0
        self.viterbi = ViterbiDecoder(kk=7, nn=2, g=(121, 91))
        self.history: list[float] = []
        self.stamps: list[int] = []
        self.synced = False
        self.inverted = False
        self.part_start = 0  # index into history of current part
        self.even_bits: np.ndarray | None = None
        self.words: list[InavWordUpdate] = []
        self.ephemeris_fields: dict = {}
        self.iod_nav: int | None = None
        self.tow_at_last_symbol_ms: float | None = None

    def feed(self, symbol: float, sample_stamp: int) -> InavWordUpdate | None:
        self.history.append(float(symbol))
        self.stamps.append(int(sample_stamp))
        self._n_fed += 1
        if self.synced or self.tow_at_last_symbol_ms is not None:
            self._last_valid = self._n_fed
        if self.tow_at_last_symbol_ms is not None:
            self.tow_at_last_symbol_ms += 4.0  # one E1 code period = 4 ms
        if not self.synced:
            self._search_sync()
            return None
        return self._try_decode_part()

    @property
    def telemetry_failed(self) -> bool:
        """No page sync within the watchdog window (the reference's
        no-valid-frame channel alarm, gps_l1_ca_telemetry_decoder_gs.cc:459
        pattern applied to I/NAV)."""
        return (not self.synced
                and self._n_fed - self._last_valid > self.watchdog_periods)

    def _search_sync(self) -> None:
        n = len(SYNC_PATTERN)
        if len(self.history) < n:
            return
        window = np.sign(self.history[-n:])
        ref = np.where(SYNC_PATTERN == 1, -1.0, 1.0)
        corr = float(np.sum(window * ref))
        if abs(corr) == n:
            self.synced = True
            self.inverted = corr < 0
            self.part_start = len(self.history) - n
            del self.history[: self.part_start]
            del self.stamps[: self.part_start]
            self.part_start = 0

    def _try_decode_part(self) -> InavWordUpdate | None:
        if len(self.history) - self.part_start < PART_SYMBOLS:
            return None
        sym = np.asarray(
            self.history[self.part_start: self.part_start + PART_SYMBOLS])
        if self.inverted:
            sym = -sym
        stamp = self.stamps[self.part_start + PART_SYMBOLS - 1]
        self.part_start += PART_SYMBOLS
        # verify the sync pattern still matches (resync on failure)
        ref = np.where(SYNC_PATTERN == 1, -1.0, 1.0)
        if float(np.sum(np.sign(sym[:10]) * ref)) != 10.0:
            self.synced = False
            self.even_bits = None
            keep = len(SYNC_PATTERN)
            self.history = self.history[-keep:]
            self.stamps = self.stamps[-keep:]
            self.part_start = 0
            return None
        bits = decode_page_part(sym, self.viterbi)
        update = None
        if bits[0] == 0:
            self.even_bits = bits
        elif self.even_bits is not None:
            ok, data = check_page_pair(self.even_bits, bits)
            self.even_bits = None
            if self.crc_stats is not None:
                self.crc_stats.update(bool(ok))
            if ok:
                fields = parse_inav_word(data)
                update = InavWordUpdate(fields["word_type"], fields, stamp)
                self.words.append(update)
                self._integrate(fields, stamp)
        # trim history
        if self.part_start > PART_SYMBOLS:
            drop = self.part_start - 1
            del self.history[:drop]
            del self.stamps[:drop]
            self.part_start -= drop
        return update

    def _integrate(self, fields: dict, stamp: int) -> None:
        wtype = fields["word_type"]
        if wtype in (1, 2, 3, 4):
            iod = fields.get("iod_nav")
            if self.iod_nav is not None and iod != self.iod_nav:
                self.ephemeris_fields = {}
            self.iod_nav = iod
            self.ephemeris_fields.update(fields)
        if wtype in (0, 5) and "tow_s" in fields:
            # TOW refers to the start of the page's even part; the odd
            # part's last symbol lands 2 s minus... the ICD stamps GST at
            # the start of the NEXT even page part: TOW at the end of this
            # odd part.
            self.tow_at_last_symbol_ms = fields["tow_s"] * 1000.0
            self.ephemeris_fields.setdefault(
                "week_number", fields.get("week_number", 0))

    def has_full_ephemeris(self) -> bool:
        f = self.ephemeris_fields
        return all(k in f for k in
                   ("sqrt_a", "ecc", "m0_rad", "omega0_rad", "i0_rad",
                    "omega_rad", "af0", "toe_s"))


def galileo_ephemeris_from_inav(prn: int, fields: dict):
    """Map accumulated I/NAV word fields onto the shared Kepler ephemeris
    container (Galileo_Ephemeris counterpart; GST == simulation time base;
    the E1/E5b broadcast group delay BGD plays the TGD role for E1
    single-frequency users)."""
    from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris

    return GpsEphemeris(
        prn=prn,
        week_number=fields.get("week_number", 0),
        iodc=fields.get("iod_nav", 0), iode=fields.get("iod_nav", 0),
        toc_s=fields.get("toc_s", 0.0), af0=fields.get("af0", 0.0),
        af1=fields.get("af1", 0.0), af2=fields.get("af2", 0.0),
        tgd_s=fields.get("bgd_e1e5b_s", 0.0),
        toe_s=fields.get("toe_s", 0.0), sqrt_a=fields.get("sqrt_a", 0.0),
        ecc=fields.get("ecc", 0.0), m0_rad=fields.get("m0_rad", 0.0),
        delta_n_rad_s=fields.get("delta_n_rad_s", 0.0),
        omega0_rad=fields.get("omega0_rad", 0.0),
        i0_rad=fields.get("i0_rad", 0.0),
        omega_rad=fields.get("omega_rad", 0.0),
        omega_dot_rad_s=fields.get("omega_dot_rad_s", 0.0),
        idot_rad_s=fields.get("idot_rad_s", 0.0),
        cuc_rad=fields.get("cuc_rad", 0.0), cus_rad=fields.get("cus_rad", 0.0),
        crc_m=fields.get("crc_m", 0.0), crs_m=fields.get("crs_m", 0.0),
        cic_rad=fields.get("cic_rad", 0.0), cis_rad=fields.get("cis_rad", 0.0),
    )
