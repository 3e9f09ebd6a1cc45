"""The port's configuration classes, device rule and import isolation."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.acquisition.pcps import AcqConfig as JAcqConfig
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JReceiverConfig
from gnss_sdr_tpu.tracking.engine import TrackingConfig as JTrackingConfig
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.acquisition.pcps import AcqConfig
from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("port,ref", [
    (TrackingConfig, JTrackingConfig), (AcqConfig, JAcqConfig),
    (ReceiverConfig, JReceiverConfig)], ids=["tracking", "acq", "receiver"])
def test_config_fields_and_defaults_match(port, ref):
    fp = [(f.name, f.default, f.type) for f in dataclasses.fields(port)]
    fr = [(f.name, f.default, f.type) for f in dataclasses.fields(ref)]
    assert fp == fr


def test_derived_config_properties_match():
    for fs in (2.5e6, 4e6):
        a, b = TrackingConfig(fs=fs), JTrackingConfig(fs=fs)
        assert a.samples_per_code == b.samples_per_code
        np.testing.assert_array_equal(a.tap_shifts(), b.tap_shifts())
        ac = AcqConfig(fs=fs, samples_per_code=a.samples_per_code,
                       pfa=0.001, max_dwells=2, code_length_chips=1023)
        bc = JAcqConfig(fs=fs, samples_per_code=a.samples_per_code,
                        pfa=0.001, max_dwells=2, code_length_chips=1023)
        assert ac.calculate_threshold() == bc.calculate_threshold()
        np.testing.assert_array_equal(ac.doppler_grid(), bc.doppler_grid())


def test_convert_config_round_trip():
    ref = JTrackingConfig(fs=4e6, extend_correlation_symbols=20,
                          pll_bw_narrow_hz=7.5)
    assert dataclasses.asdict(convert.config(ref, TrackingConfig)) \
        == dataclasses.asdict(ref)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    from gnss_sdr_tpu_torch.tracking.engine import TrackingEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        TrackingEngine(TrackingConfig(fs=2.5e6), 2, 50000)
    from gnss_sdr_tpu_torch.receiver.production import ProductionReceiver

    with pytest.raises(RuntimeError, match="CUDA"):
        ProductionReceiver(ReceiverConfig(fs=2.5e6, n_channels=2,
                                          extend_correlation_symbols=20),
                           satellites=[1, 2])
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_isolation():
    """Importing the port, every module of it (the conditioner, the live
    and LabSat sources, the Galileo E1 codes and I/NAV telemetry, the
    multi-band receivers, the acquisition variants and the KF/Gaussian
    loops among them) and chip_smoke leaves JAX and the
    JAX package out of sys.modules (fresh interpreter: the test process
    itself has JAX loaded by conftest)."""
    code = r"""
import importlib, pkgutil, sys
import gnss_sdr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gnss_sdr_tpu_torch.__path__,
                                              "gnss_sdr_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "gnss_sdr_tpu" or m.startswith("gnss_sdr_tpu.")]
assert not bad, bad
assert len(mods) > 30, mods
need = {"gnss_sdr_tpu_torch.conditioner.chain",
        "gnss_sdr_tpu_torch.conditioner.fir",
        "gnss_sdr_tpu_torch.conditioner.interference",
        "gnss_sdr_tpu_torch.conditioner.resampler",
        "gnss_sdr_tpu_torch.kernels.conditioner",
        "gnss_sdr_tpu_torch.sources.live",
        "gnss_sdr_tpu_torch.sources.labsat",
        "gnss_sdr_tpu_torch.codes.galileo_e1",
        "gnss_sdr_tpu_torch.codes._galileo_e1_data",
        "gnss_sdr_tpu_torch.telemetry.viterbi",
        "gnss_sdr_tpu_torch.telemetry.galileo_inav",
        "gnss_sdr_tpu_torch.receiver.bands",
        "gnss_sdr_tpu_torch.receiver.multiband",
        "gnss_sdr_tpu_torch.receiver.production_multiband",
        "gnss_sdr_tpu_torch.acquisition.variants",
        "gnss_sdr_tpu_torch.acquisition.tong",
        "gnss_sdr_tpu_torch.kernels.acq_variants",
        "gnss_sdr_tpu_torch.kernels.loops",
        "gnss_sdr_tpu_torch.kernels.scan_loop",
        "gnss_sdr_tpu_torch.kernels.fast_loop",
        "gnss_sdr_tpu_torch.ops.kalman",
        "gnss_sdr_tpu_torch.ops.gaussian",
        "gnss_sdr_tpu_torch.codes.galileo_e5a",
        "gnss_sdr_tpu_torch.codes._galileo_e5a_data"}
assert need <= set(mods), need - set(mods)
print("ok", len(mods))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the chip script exits non-zero and prints no
    result; so it does from a directory holding nothing else."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, None)):
        if script is None:
            script = tmp_path / "chip_smoke.py"
            script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_cli_accepts_cn0_min_and_max_lock_fail(tmp_path, monkeypatch):
    """``--cn0_min`` and ``--max_lock_fail`` parse as in the JAX CLI and,
    as there, leave the configuration that ``main`` builds unchanged."""
    import gnss_sdr_tpu_torch.__main__ as cli
    from gnss_sdr_tpu_torch.receiver import factory

    conf = tmp_path / "rx.conf"
    conf.write_text("Channels_1C.count=2\nTracking_1C.pll_bw_hz=30\n")
    extra = ["--cn0_min", "30", "--max_lock_fail", "10"]
    args = cli.build_parser().parse_args(["-c", str(conf), *extra])
    assert (args.cn0_min, args.max_lock_fail) == (30.0, 10)
    built = []

    def no_source(config):
        # the configuration main hands to the factory; no source ends the
        # run there
        built.append({k: config.property(k, "") for k in config.keys()})
    monkeypatch.setattr(factory, "make_signal_source", no_source)
    for more in ([], extra):
        assert cli.main(["-c", str(conf), "--device", "cpu", "--pll_bw_hz",
                         "20", *more]) == 2
    assert built[0] == built[1]
    assert built[0]["Tracking_1C.pll_bw_hz"] == "20.0"
