"""Counterpart of ``gnss_sdr_tpu/monitor``."""
