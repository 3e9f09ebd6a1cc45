"""GPS LNAV (L1 C/A) navigation-message decoding.

Covers the roles of the reference's symbol-level decoder block
(gnss-sdr/src/algorithms/telemetry_decoder/gnuradio_blocks/
gps_l1_ca_telemetry_decoder_gs.cc: preamble correlation :477-491, word
parity :187-210, subframe assembly :257-340) and the frame parser
(gnss-sdr/src/core/system_parameters/gps_navigation_message.cc):

- Hamming (32,26) word parity per IS-GPS-200 Table 20-XIV, implemented from
  the published XOR equations rather than the reference's magic-constant
  rotation trick.
- 160-symbol (8 bit x 20 symbol) preamble search over the soft-symbol
  history with polarity resolution.
- Subframe 1-3 field extraction with ICD scale factors into a dict that
  feeds :class:`gnss_sdr_tpu_torch.pvt.ephemeris.GpsEphemeris`.
- TOW propagation: the HOW's truncated TOW stamps the symbol stream; every
  subsequent code period advances it by 1 ms.

Copied from ``gnss_sdr_tpu/telemetry/gps_lnav.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int64)
SYMBOLS_PER_BIT = 20
BITS_PER_WORD = 30
WORDS_PER_SUBFRAME = 10
BITS_PER_SUBFRAME = 300
SYMBOLS_PER_SUBFRAME = BITS_PER_SUBFRAME * SYMBOLS_PER_BIT  # 6000
PREAMBLE_SYMBOLS = np.repeat(np.where(PREAMBLE_BITS == 1, 1.0, -1.0),
                             SYMBOLS_PER_BIT)  # 160 symbols

# IS-GPS-200 Table 20-XIV parity equations: for each parity bit D25..D30,
# the source-bit indices (1-based d1..d24) XORed together. D25,D27,D30 also
# XOR D29*; D26,D28,D29 also XOR D30* (captured by _PARITY_PREV).
_PARITY_SOURCES = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),          # D25
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),          # D26
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),           # D27
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),           # D28
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),       # D29
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),              # D30
)
_PARITY_PREV = ("D29", "D30", "D29", "D30", "D30", "D29")


def compute_parity(source24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Six parity bits from 24 source bits + previous word's D29*/D30*."""
    out = np.empty(6, dtype=np.int64)
    for k, (sources, prev) in enumerate(zip(_PARITY_SOURCES, _PARITY_PREV)):
        acc = d29s if prev == "D29" else d30s
        for i in sources:
            acc ^= int(source24[i - 1])
        out[k] = acc
    return out


def encode_word(source24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Transmitted 30-bit word: data bits XOR D30*, then parity
    (IS-GPS-200 20.3.5: D1..24 = d XOR D30*; D25..30 from source bits)."""
    source24 = np.asarray(source24, dtype=np.int64)
    data = source24 ^ d30s
    parity = compute_parity(source24, d29s, d30s)
    return np.concatenate([data, parity])


def solve_parity_bits(source22: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Choose the 2 trailing non-information bits so D29=D30=0 (used by
    words 2 and 10 of every subframe so each subframe starts with known
    polarity, IS-GPS-200 20.3.3.2)."""
    for t1 in (0, 1):
        for t2 in (0, 1):
            cand = np.concatenate([source22, [t1, t2]])
            parity = compute_parity(cand, d29s, d30s)
            if parity[4] == 0 and parity[5] == 0:
                return cand
    raise AssertionError("parity solve must succeed for some (t1, t2)")


def check_word(word30: np.ndarray, d29s: int, d30s: int):
    """Validate one received word; returns (ok, source24 bits)."""
    word30 = np.asarray(word30, dtype=np.int64)
    source = word30[:24] ^ d30s
    expected = compute_parity(source, d29s, d30s)
    ok = bool(np.array_equal(expected, word30[24:]))
    return ok, source


def check_subframe(bits300: np.ndarray, d29s: int, d30s: int):
    """Parity-check all 10 words; returns (all_ok, source bits [10, 24])."""
    bits300 = np.asarray(bits300, dtype=np.int64)
    sources = np.empty((WORDS_PER_SUBFRAME, 24), dtype=np.int64)
    all_ok = True
    for w in range(WORDS_PER_SUBFRAME):
        word = bits300[w * 30:(w + 1) * 30]
        ok, src = check_word(word, d29s, d30s)
        all_ok &= ok
        sources[w] = src
        d29s, d30s = int(word[28]), int(word[29])
    return all_ok, sources


# ---------------------------------------------------------------------------
# Field extraction (gps_navigation_message.cc read_navigation_* semantics)
# ---------------------------------------------------------------------------


def _bits_to_uint(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _bits_to_int(bits: np.ndarray) -> int:
    v = _bits_to_uint(bits)
    if bits[0] == 1:
        v -= 1 << len(bits)
    return v


def _field(sources: np.ndarray, word: int, first: int, last: int) -> np.ndarray:
    """Source-bit slice by ICD numbering: word 1..10, bits 1..24 within the
    word's data bits."""
    return sources[word - 1][first - 1:last]


def parse_subframe(sources: np.ndarray) -> dict:
    """Decode one subframe's fields (IS-GPS-200 20.3.3).

    ``sources`` is the [10, 24] source-bit array from check_subframe.
    Returns a dict with 'subframe_id', 'tow_ms' (TOW at *next* subframe
    start) and the subframe's ephemeris/clock fields in SI units
    (semicircles already converted to radians).
    """
    pi = np.pi
    out: dict = {}
    out["tow_truncated"] = _bits_to_uint(_field(sources, 2, 1, 17))
    # HOW TOW counts 6 s units and refers to the next subframe start
    out["tow_ms"] = out["tow_truncated"] * 6000
    sf_id = _bits_to_uint(_field(sources, 2, 20, 22))
    out["subframe_id"] = sf_id

    if sf_id == 1:
        out["week_number"] = _bits_to_uint(_field(sources, 3, 1, 10))
        out["sv_accuracy"] = _bits_to_uint(_field(sources, 3, 13, 16))
        out["sv_health"] = _bits_to_uint(_field(sources, 3, 17, 22))
        iodc_msb = _bits_to_uint(_field(sources, 3, 23, 24))
        out["tgd_s"] = _bits_to_int(_field(sources, 7, 17, 24)) * 2.0**-31
        iodc_lsb = _bits_to_uint(_field(sources, 8, 1, 8))
        out["iodc"] = (iodc_msb << 8) | iodc_lsb
        out["toc_s"] = _bits_to_uint(_field(sources, 8, 9, 24)) * 16.0
        out["af2"] = _bits_to_int(_field(sources, 9, 1, 8)) * 2.0**-55
        out["af1"] = _bits_to_int(_field(sources, 9, 9, 24)) * 2.0**-43
        out["af0"] = _bits_to_int(_field(sources, 10, 1, 22)) * 2.0**-31
    elif sf_id == 2:
        out["iode"] = _bits_to_uint(_field(sources, 3, 1, 8))
        out["crs_m"] = _bits_to_int(_field(sources, 3, 9, 24)) * 2.0**-5
        out["delta_n_rad_s"] = _bits_to_int(_field(sources, 4, 1, 16)) \
            * 2.0**-43 * pi
        m0 = np.concatenate([_field(sources, 4, 17, 24),
                             _field(sources, 5, 1, 24)])
        out["m0_rad"] = _bits_to_int(m0) * 2.0**-31 * pi
        out["cuc_rad"] = _bits_to_int(_field(sources, 6, 1, 16)) * 2.0**-29
        ecc = np.concatenate([_field(sources, 6, 17, 24),
                              _field(sources, 7, 1, 24)])
        out["ecc"] = _bits_to_uint(ecc) * 2.0**-33
        out["cus_rad"] = _bits_to_int(_field(sources, 8, 1, 16)) * 2.0**-29
        sqrt_a = np.concatenate([_field(sources, 8, 17, 24),
                                 _field(sources, 9, 1, 24)])
        out["sqrt_a"] = _bits_to_uint(sqrt_a) * 2.0**-19
        out["toe_s"] = _bits_to_uint(_field(sources, 10, 1, 16)) * 16.0
    elif sf_id == 3:
        out["cic_rad"] = _bits_to_int(_field(sources, 3, 1, 16)) * 2.0**-29
        omega0 = np.concatenate([_field(sources, 3, 17, 24),
                                 _field(sources, 4, 1, 24)])
        out["omega0_rad"] = _bits_to_int(omega0) * 2.0**-31 * pi
        out["cis_rad"] = _bits_to_int(_field(sources, 5, 1, 16)) * 2.0**-29
        i0 = np.concatenate([_field(sources, 5, 17, 24),
                             _field(sources, 6, 1, 24)])
        out["i0_rad"] = _bits_to_int(i0) * 2.0**-31 * pi
        out["crc_m"] = _bits_to_int(_field(sources, 7, 1, 16)) * 2.0**-5
        omega = np.concatenate([_field(sources, 7, 17, 24),
                                _field(sources, 8, 1, 24)])
        out["omega_rad"] = _bits_to_int(omega) * 2.0**-31 * pi
        out["omega_dot_rad_s"] = _bits_to_int(_field(sources, 9, 1, 24)) \
            * 2.0**-43 * pi
        out["iode_sf3"] = _bits_to_uint(_field(sources, 10, 1, 8))
        out["idot_rad_s"] = _bits_to_int(_field(sources, 10, 9, 22)) \
            * 2.0**-43 * pi
    elif sf_id in (4, 5):
        out["data_id"] = _bits_to_uint(_field(sources, 3, 1, 2))
        sv_id = _bits_to_uint(_field(sources, 3, 3, 8))
        out["sv_page_id"] = sv_id
        if sf_id == 4 and sv_id == 56:
            # page 18: ionosphere (Klobuchar) + UTC (IS-GPS-200 20.3.3.5.1.7)
            out["iono_alpha"] = (
                _bits_to_int(_field(sources, 3, 9, 16)) * 2.0**-30,
                _bits_to_int(_field(sources, 3, 17, 24)) * 2.0**-27,
                _bits_to_int(_field(sources, 4, 1, 8)) * 2.0**-24,
                _bits_to_int(_field(sources, 4, 9, 16)) * 2.0**-24,
            )
            out["iono_beta"] = (
                _bits_to_int(_field(sources, 4, 17, 24)) * 2.0**11,
                _bits_to_int(_field(sources, 5, 1, 8)) * 2.0**14,
                _bits_to_int(_field(sources, 5, 9, 16)) * 2.0**16,
                _bits_to_int(_field(sources, 5, 17, 24)) * 2.0**16,
            )
            out["utc_a1"] = _bits_to_int(_field(sources, 6, 1, 24)) * 2.0**-50
            a0 = np.concatenate([_field(sources, 7, 1, 24),
                                 _field(sources, 8, 1, 8)])
            out["utc_a0"] = _bits_to_int(a0) * 2.0**-30
            out["utc_tot_s"] = _bits_to_uint(_field(sources, 8, 9, 16)) \
                * 2.0**12
            out["utc_wn_t"] = _bits_to_uint(_field(sources, 8, 17, 24))
            out["delta_t_ls"] = _bits_to_int(_field(sources, 9, 1, 8))
        elif 1 <= sv_id <= 32:
            # almanac page (IS-GPS-200 20.3.3.5.1.2)
            out["alm_prn"] = sv_id
            out["alm_ecc"] = _bits_to_uint(_field(sources, 3, 9, 24)) \
                * 2.0**-21
            out["alm_toa_s"] = _bits_to_uint(_field(sources, 4, 1, 8)) \
                * 2.0**12
            out["alm_delta_i_rad"] = _bits_to_int(_field(sources, 4, 9, 24)) \
                * 2.0**-19 * pi
            out["alm_omega_dot_rad_s"] = _bits_to_int(
                _field(sources, 5, 1, 16)) * 2.0**-38 * pi
            out["alm_health"] = _bits_to_uint(_field(sources, 5, 17, 24))
            out["alm_sqrt_a"] = _bits_to_uint(_field(sources, 6, 1, 24)) \
                * 2.0**-11
            out["alm_omega0_rad"] = _bits_to_int(_field(sources, 7, 1, 24)) \
                * 2.0**-23 * pi
            out["alm_omega_rad"] = _bits_to_int(_field(sources, 8, 1, 24)) \
                * 2.0**-23 * pi
            out["alm_m0_rad"] = _bits_to_int(_field(sources, 9, 1, 24)) \
                * 2.0**-23 * pi
            af0 = np.concatenate([_field(sources, 10, 1, 8),
                                  _field(sources, 10, 20, 22)])
            out["alm_af0"] = _bits_to_int(af0) * 2.0**-20
            out["alm_af1"] = _bits_to_int(_field(sources, 10, 9, 19)) \
                * 2.0**-38
    return out


# ---------------------------------------------------------------------------
# Streaming decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TowUpdate:
    """A decoded HOW: TOW (ms) valid at the last symbol of this subframe."""

    tow_ms: int
    sample_stamp: int        # sample index of that symbol's period end
    subframe_id: int
    fields: dict


class GpsLnavDecoder:
    """Per-channel streaming LNAV decoder.

    Feed one soft symbol (prompt I) per code period via :meth:`feed`. After
    preamble lock, every 6000 symbols a subframe is parity-checked and
    parsed. TOW is propagated per symbol; :attr:`tow_at_last_symbol_ms` is
    None until the first valid HOW.
    """

    # keep a bit more than one subframe of history so a confirmed candidate
    # subframe can be decoded retroactively
    _HISTORY_CAP = SYMBOLS_PER_SUBFRAME + 400

    #: telemetry watchdog: symbols without a valid frame before the
    #: channel is declared bad (gps_l1_ca_telemetry_decoder_gs.cc:118,459
    #: — d_required_symbols * 20); receivers force loss-of-lock on
    #: :attr:`telemetry_failed`
    WATCHDOG_SYMBOLS = 6000 * 20

    def __init__(self, crc_stats=None, watchdog_symbols: int | None = None):
        #: optional TlmCrcStats fed with every word-parity outcome
        #: (tlm_crc_stats.cc role)
        self.crc_stats = crc_stats
        self.watchdog_symbols = (self.WATCHDOG_SYMBOLS
                                 if watchdog_symbols is None
                                 else int(watchdog_symbols))
        self._last_valid_symbol = 0
        self.history: list[float] = []
        self.stamps: list[int] = []
        self.base = 0                    # absolute symbol index of history[0]
        self.n_symbols = 0               # absolute symbols fed
        self.frame_sync = False
        self.inverted = False
        self.frame_start: int | None = None  # absolute symbol index
        self.candidates: list[tuple[int, bool]] = []  # (abs pos, inverted)
        self.tow_at_last_symbol_ms: float | None = None
        self.subframes: list[TowUpdate] = []
        self.ephemeris_fields: dict = {}
        self.utc_iono_fields: dict = {}
        self.prev_d29 = 0
        self.prev_d30 = 0

    def feed(self, symbol: float, sample_stamp: int) -> TowUpdate | None:
        self.history.append(float(symbol))
        self.stamps.append(int(sample_stamp))
        self.n_symbols += 1
        if self.tow_at_last_symbol_ms is not None:
            self.tow_at_last_symbol_ms += 1.0  # one code period = 1 ms

        update = None
        if not self.frame_sync:
            update = self._preamble_search()
        else:
            update = self._try_decode_subframe()
        if update is not None or self.frame_sync:
            self._last_valid_symbol = self.n_symbols
        self._trim_history()
        return update

    @property
    def telemetry_failed(self) -> bool:
        """No valid frame within the watchdog window while unsynced — the
        reference posts "bad telemetry" to tracking, which forces loss of
        lock (gps_l1_ca_telemetry_decoder_gs.cc:456-464)."""
        return (not self.frame_sync
                and self.n_symbols - self._last_valid_symbol
                > self.watchdog_symbols)

    def feed_array(self, symbols, stamps) -> np.ndarray:
        """Vectorized bulk feed: equivalent to per-symbol :meth:`feed` on
        clean streams, at array speed (the production receiver's
        steady-state path feeds ~1000 symbols/s/channel; per-call Python
        overhead would dominate the host budget).

        Returns the per-symbol TOW [ms] (value *after* that symbol, the
        same quantity ``tow_at_last_symbol_ms`` holds after feed()), NaN
        where unknown. Divergence from per-symbol feeding, by design:
        a mid-chunk loss of frame sync resumes the preamble search at the
        next chunk, and a mid-chunk subframe re-anchor reflects in TOWs
        from the chunk end instead of the exact subframe edge (identical
        on streams without symbol slips).
        """
        symbols = np.asarray(symbols, dtype=np.float64)
        stamps_arr = np.asarray(stamps, dtype=np.int64)
        n = len(symbols)
        tows = np.full(n, np.nan)
        i = 0
        while i < n:
            if self.frame_sync:
                rem = n - i
                tow0 = self.tow_at_last_symbol_ms
                self.history.extend(symbols[i:].tolist())
                self.stamps.extend(stamps_arr[i:].tolist())
                self.n_symbols += rem
                if tow0 is not None:
                    self.tow_at_last_symbol_ms = tow0 + rem
                    tows[i:] = tow0 + np.arange(1, rem + 1, dtype=np.float64)
                while self.frame_sync:
                    if self._try_decode_subframe() is None:
                        break
                if self.tow_at_last_symbol_ms is not None:
                    # a decode may have (re)anchored TOW; the chunk tail is
                    # exact from the latest anchor
                    tows[n - 1] = self.tow_at_last_symbol_ms
                    if np.isnan(tows[i:]).any():
                        tows[i:] = self.tow_at_last_symbol_ms \
                            - np.arange(rem - 1, -1, -1, dtype=np.float64)
                i = n
                self._trim_history()
            else:
                consumed = self._search_array(symbols[i:], stamps_arr[i:])
                if self.tow_at_last_symbol_ms is not None:
                    tows[i + consumed - 1] = self.tow_at_last_symbol_ms
                i += consumed
                self._trim_history()
        return tows

    def _search_array(self, symbols: np.ndarray,
                      stamps: np.ndarray) -> int:
        """Vectorized preamble scan over a chunk; consumes symbols up to
        (and including) a confirming preamble, or the whole chunk."""
        n_pre = len(PREAMBLE_SYMBOLS)
        tail = np.sign(np.asarray(self.history[-(n_pre - 1):], dtype=float)) \
            if self.history else np.zeros(0)
        t = len(tail)
        signs = np.concatenate([tail, np.sign(symbols)])
        if len(signs) >= n_pre:
            corr = np.correlate(signs, PREAMBLE_SYMBOLS, mode="valid")
            hits = np.nonzero(np.abs(corr) == n_pre)[0]
        else:
            corr = np.zeros(0)
            hits = np.zeros(0, dtype=np.int64)
        for m in hits:
            j = int(m) + n_pre - 1 - t       # chunk index of preamble end
            if j < 0:
                continue
            pos = self.n_symbols + j + 1 - n_pre   # absolute preamble start
            inverted = corr[m] < 0
            confirmed = any(
                pos - c_pos == SYMBOLS_PER_SUBFRAME and c_inv == inverted
                for c_pos, c_inv in self.candidates)
            self.candidates = [
                (p, iv) for p, iv in self.candidates
                if pos - p < SYMBOLS_PER_SUBFRAME] + [(pos, bool(inverted))]
            if confirmed:
                self.history.extend(symbols[:j + 1].tolist())
                self.stamps.extend(stamps[:j + 1].tolist())
                self.n_symbols += j + 1
                self.frame_sync = True
                self.inverted = bool(inverted)
                self.frame_start = pos - SYMBOLS_PER_SUBFRAME
                self.candidates = []
                while self.frame_sync and self._try_decode_subframe() \
                        is not None:
                    pass
                return j + 1
        self.history.extend(symbols.tolist())
        self.stamps.extend(stamps.tolist())
        self.n_symbols += len(symbols)
        return len(symbols)

    # -- internals --------------------------------------------------------
    def _abs(self, abs_index: int) -> int:
        return abs_index - self.base

    def _trim_history(self) -> None:
        excess = len(self.history) - self._HISTORY_CAP
        if excess > 0:
            del self.history[:excess]
            del self.stamps[:excess]
            self.base += excess

    def _preamble_search(self) -> TowUpdate | None:
        """Two-stage sync like the reference (d_stat 0->1->2,
        gps_l1_ca_telemetry_decoder_gs.cc:423-470): a preamble candidate is
        confirmed when a second detection lands exactly one subframe
        (6000 symbols) later with the same polarity; the straddled subframe
        is then decoded retroactively."""
        n = len(PREAMBLE_SYMBOLS)
        if len(self.history) < n:
            return None
        window = np.asarray(self.history[-n:])
        corr = float(np.sum(np.sign(window) * PREAMBLE_SYMBOLS))
        if abs(corr) != n:
            return None
        pos = self.n_symbols - n  # absolute start of this preamble
        inverted = corr < 0
        confirmed = any(
            pos - c_pos == SYMBOLS_PER_SUBFRAME and c_inv == inverted
            for c_pos, c_inv in self.candidates)
        self.candidates = [
            (p, i) for p, i in self.candidates
            if pos - p < SYMBOLS_PER_SUBFRAME] + [(pos, inverted)]
        if not confirmed:
            return None
        self.frame_sync = True
        self.inverted = inverted
        self.frame_start = pos - SYMBOLS_PER_SUBFRAME
        self.candidates = []
        return self._try_decode_subframe()

    def _try_decode_subframe(self) -> TowUpdate | None:
        assert self.frame_start is not None
        start = self._abs(self.frame_start)
        if start < 0:
            # history no longer covers the frame start; resync forward
            self.frame_start += SYMBOLS_PER_SUBFRAME * (
                (-start) // SYMBOLS_PER_SUBFRAME + 1)
            return None
        if len(self.history) - start < SYMBOLS_PER_SUBFRAME:
            return None
        sym = np.asarray(self.history[start: start + SYMBOLS_PER_SUBFRAME])
        if self.inverted:
            sym = -sym
        bits = (np.sum(sym.reshape(BITS_PER_SUBFRAME, SYMBOLS_PER_BIT),
                       axis=1) > 0).astype(np.int64)
        ok, sources = check_subframe(bits, self.prev_d29, self.prev_d30)
        if self.crc_stats is not None:
            self.crc_stats.update(bool(ok))
        last_word = bits[-30:]
        stamp = self.stamps[start + SYMBOLS_PER_SUBFRAME - 1]
        self.frame_start += SYMBOLS_PER_SUBFRAME

        if not ok:
            # lost sync: back to two-stage preamble search
            self.frame_sync = False
            self.frame_start = None
            self.candidates = []
            return None

        self.prev_d29, self.prev_d30 = int(last_word[28]), int(last_word[29])
        fields = parse_subframe(sources)
        # HOW TOW refers to the next subframe start, which coincides with
        # the END of this subframe's last symbol period. When decoding
        # retroactively (confirmation arrives 160 symbols into the next
        # subframe) the current symbol is past that edge.
        lag = self.n_symbols - (self.frame_start)
        self.tow_at_last_symbol_ms = float(fields["tow_ms"]) + float(lag)
        update = TowUpdate(
            tow_ms=fields["tow_ms"], sample_stamp=stamp,
            subframe_id=fields["subframe_id"], fields=fields,
        )
        self.subframes.append(update)
        if fields["subframe_id"] in (1, 2, 3):
            self.ephemeris_fields.update(fields)
        elif "iono_alpha" in fields:
            # subframe 4 page 18: broadcast ionosphere/UTC for the PVT layer
            self.utc_iono_fields.update(fields)
        return update

    def has_full_ephemeris(self) -> bool:
        f = self.ephemeris_fields
        return all(k in f for k in
                   ("af0", "toe_s", "sqrt_a", "omega0_rad", "i0_rad"))
