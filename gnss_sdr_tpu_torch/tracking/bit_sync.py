"""Data-bit boundary synchronization (host-side).

Counterpart of the reference's symbol-synchronization logic in tracking
state 2 (dll_pll_veml_tracking.cc:1845-1986): watches prompt-sign
transitions; when several consecutive transitions agree on the same
phase modulo symbols_per_bit, the bit boundary is declared. The receiver
then flips the channel into extended coherent integration aligned to it.

Copied from ``gnss_sdr_tpu/tracking/bit_sync.py``; only the import paths differ.
"""

from __future__ import annotations


class BitSync:
    def __init__(self, symbols_per_bit: int = 20, required: int = 8,
                 window: int = 24):
        self.spb = symbols_per_bit
        self.required = required
        self.count = 0
        self._last_sign = 0.0
        # sliding window of recent transition phases: during FLL pull-in
        # the prompt rotates through zero at arbitrary phases, and a
        # cumulative histogram poisoned by those votes can stay below the
        # 2x-margin test for many seconds after the loops settle (the
        # margin denominator never decays). Scoring only the latest
        # ``window`` transitions ages the pull-in garbage out within a
        # couple of bits of clean tracking.
        import collections

        self._recent: collections.deque[int] = collections.deque(
            maxlen=window)
        self.bit_phase: int | None = None  # period index mod spb of boundary

    @property
    def synced(self) -> bool:
        return self.bit_phase is not None

    def feed(self, prompt_i: float) -> bool:
        """One prompt per code period; returns True when sync is achieved
        on this symbol.

        Sliding-window histogram voting: every sign transition votes for
        its phase; sync when, among the most recent transitions, the
        leading phase has ``required`` votes and a 2x margin over the
        runner-up (robust at low C/N0 where noise adds spurious
        transitions at random phases, and against pull-in transients)."""
        idx = self.count
        self.count += 1
        sign = 1.0 if prompt_i >= 0 else -1.0
        if self._last_sign != 0.0 and sign != self._last_sign \
                and not self.synced:
            self._recent.append(idx % self.spb)
            votes = [0] * self.spb
            for ph in self._recent:
                votes[ph] += 1
            ranked = sorted(votes, reverse=True)
            if ranked[0] >= self.required and ranked[0] >= 2 * (ranked[1] + 1):
                self.bit_phase = int(max(range(self.spb),
                                         key=votes.__getitem__))
                self._last_sign = sign
                return True
        self._last_sign = sign
        return False

    def periods_into_bit(self, next_period_index: int) -> int:
        """How many periods of the current bit have elapsed before the
        period with the given index."""
        assert self.bit_phase is not None
        return (next_period_index - self.bit_phase) % self.spb


class SecondaryCodeSync:
    """Secondary-code phase search for pilot channels.

    Counterpart of acquire_secondary (dll_pll_veml_tracking.cc:923-968):
    correlate the prompt history against the known secondary sequence at
    every cyclic phase; declare sync when one phase dominates.
    """

    def __init__(self, code: str, repeats: int = 4):
        self.signs = [1.0 if c in "0+" else -1.0 for c in code]
        self.k = len(self.signs)
        self.repeats = repeats
        self.history: list[float] = []
        self.count = 0
        self.phase: int | None = None   # period index mod K of code start
        self.inverted = False

    @property
    def synced(self) -> bool:
        return self.phase is not None

    def feed(self, prompt_i: float) -> bool:
        self.history.append(1.0 if prompt_i >= 0 else -1.0)
        self.count += 1
        if self.synced or len(self.history) < self.repeats * self.k:
            return False
        window = self.history[-self.repeats * self.k:]
        best, best_phase, second, best_sign = 0.0, 0, 0.0, 0.0
        for ph in range(self.k):
            corr = sum(
                window[i] * self.signs[(i + ph) % self.k]
                for i in range(len(window)))
            a = abs(corr)
            if a > best:
                second = best
                best, best_phase, best_sign = a, ph, corr
            elif a > second:
                second = a
        if best == self.repeats * self.k and best > 2 * second:
            # window starts at absolute period (count - repeats*k); its
            # secondary index was best_phase
            start_abs = self.count - self.repeats * self.k
            self.phase = (best_phase - start_abs) % self.k
            self.inverted = best_sign < 0
            return True
        return False

    def periods_into_code(self, next_period_index: int) -> int:
        """Secondary-code index of the period with the given absolute
        index (what set_extended needs as periods_into_group)."""
        assert self.phase is not None
        return (next_period_index + self.phase) % self.k
