"""Key->string property stores with typed accessors.

Copied from ``gnss_sdr_tpu/config/configuration.py``; only the import paths differ.
"""

from __future__ import annotations

import os
from typing import TypeVar

T = TypeVar("T")

_TRUE_STRINGS = {"true", "1", "yes", "on"}
_FALSE_STRINGS = {"false", "0", "no", "off"}


class Configuration:
    """Base property store.

    Typed accessors mirror ``ConfigurationInterface::property(key, default)``
    (gnss-sdr/src/core/interfaces/configuration_interface.h): a
    missing key or an unparsable value yields the default.
    """

    def __init__(self, properties: dict[str, str] | None = None):
        self._properties: dict[str, str] = dict(properties or {})

    # -- mutation ---------------------------------------------------------
    def set_property(self, key: str, value: object) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._properties[key] = str(value)

    def unset_property(self, key: str) -> None:
        self._properties.pop(key, None)

    # -- access -----------------------------------------------------------
    def is_present(self, key: str) -> bool:
        return key in self._properties

    def property(self, key: str, default: T) -> T:
        """Typed lookup; the default's type selects the parser."""
        if key not in self._properties:
            return default
        raw = self._properties[key].strip()
        try:
            if isinstance(default, bool):
                low = raw.lower()
                if low in _TRUE_STRINGS:
                    return True  # type: ignore[return-value]
                if low in _FALSE_STRINGS:
                    return False  # type: ignore[return-value]
                return default
            if isinstance(default, int):
                return int(raw, 0)  # type: ignore[return-value]
            if isinstance(default, float):
                return float(raw)  # type: ignore[return-value]
            return raw  # type: ignore[return-value]
        except ValueError:
            return default

    def keys(self) -> list[str]:
        return sorted(self._properties)

    def role_properties(self, role: str) -> dict[str, str]:
        """All ``role.key`` properties with the role prefix stripped."""
        prefix = role + "."
        return {
            k[len(prefix):]: v
            for k, v in self._properties.items()
            if k.startswith(prefix)
        }

    def apply_overrides(self, overrides: dict[str, str]) -> None:
        """CLI-style overrides, the analogue of the reference's gflags layer
        (gnss-sdr/src/algorithms/libs/gnss_sdr_flags.cc). Values for
        flags with validators are range-checked like the reference's
        DEFINE_validator functions (:223-233) and rejected with the same
        allowed-range message."""
        for key, value in overrides.items():
            flag = key.rsplit(".", 1)[-1]
            validator = FLAG_VALIDATORS.get(flag)
            if validator is not None:
                lo, hi, unit, lo_ok = validator
                try:
                    num = float(value)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"Invalid value for flag -{flag}: {value!r} "
                        f"(not a number)")
                ok = (num >= lo if lo_ok else num > lo) and num < hi
                if not ok:
                    raise ValueError(
                        f"Invalid value for flag -{flag}: {value}. Allowed "
                        f"range is {lo} < {flag} < {hi} {unit}.")
            self.set_property(key, value)


# flag -> (low, high, unit, low_inclusive), gnss_sdr_flags.cc validators
FLAG_VALIDATORS: dict[str, tuple[float, float, str, bool]] = {
    "doppler_max": (0.0, 1_000_000.0, "Hz", True),
    "doppler_step": (0.0, 10_000.0, "Hz", False),
    "cn0_samples": (0.0, 10_000.0, "samples", False),
    "cn0_min": (0.0, 100.0, "dB-Hz", False),
    "max_lock_fail": (0.0, 10_000.0, "events", False),
    "carrier_lock_th": (0.0, 1.508, "rad", False),
    "dll_bw_hz": (0.0, 10_000.0, "Hz", True),
    "pll_bw_hz": (0.0, 10_000.0, "Hz", True),
    "fll_bw_hz": (0.0, 10_000.0, "Hz", True),
}


class InMemoryConfiguration(Configuration):
    """Programmatic configuration for tests
    (gnss-sdr/src/core/receiver/in_memory_configuration.cc)."""


class FileConfiguration(Configuration):
    """INI-file-backed configuration
    (gnss-sdr/src/core/receiver/file_configuration.cc).

    Dotted keys are read verbatim; ``[section]`` headers prefix subsequent
    keys with ``section.`` unless the section is ``GNSS-SDR`` (the
    reference conf files place global keys under no/global section).
    """

    def __init__(self, path: str | os.PathLike):
        super().__init__()
        self.path = str(path)
        self._parse(self.path)

    def _parse(self, path: str) -> None:
        section = ""
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith((";", "#")):
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = line[1:-1].strip()
                    continue
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key = key.strip()
                # strip trailing inline comments
                value = value.split(";", 1)[0].split("#", 1)[0].strip()
                if section and "." not in key:
                    key = f"{section}.{key}"
                self._properties[key] = value
