"""Counterpart of ``gnss_sdr_tpu/telemetry``."""
