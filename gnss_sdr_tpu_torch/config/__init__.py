"""Configuration system (reference layer L1).

Key->string property stores with typed accessors and defaults, matching the
semantics of the reference's ``ConfigurationInterface`` implementations
(gnss-sdr/src/core/receiver/file_configuration.cc and
in_memory_configuration.cc): every component reads ``role.key`` properties
with per-call defaults; unknown keys silently return the default.

The INI dialect matches the reference's INIReader usage
(gnss-sdr/src/core/libs/ini.cc): ``key=value`` lines, ``;`` or ``#``
comments, optional ``[section]`` headers (the reference conf files use the
global section with dotted keys such as ``Acquisition_1C.doppler_max``).

Copied from ``gnss_sdr_tpu/config/__init__.py``; only the import paths differ.
"""

from gnss_sdr_tpu_torch.config.configuration import (
    Configuration,
    FileConfiguration,
    InMemoryConfiguration,
)

__all__ = ["Configuration", "FileConfiguration", "InMemoryConfiguration"]
