"""The port's production receiver end to end on the CPU, held against
the JAX receiver on the scene of ``tests/test_production.py``
(2.5 Msps, 5 channels, 9.8 s, 48 dB-Hz).

- The port alone: fast mode, handoff before 4 s, >= 5 fixes, mean 3-D
  error of the second half under 5 m (``test_production.py``).
- Against the JAX receiver: the same handoff sample (the same phase-A
  superblock), and fixes at common epochs within 1 m of each other.
- The CLI (``python -m gnss_sdr_tpu_torch -c rx.conf --device cpu``)
  prints GGA fixes in fast mode (``test_cli.py``), also over the scene
  upsampled to 5 Msps at an IF of 1.25 MHz through the
  ``Freq_Xlating_Fir_Filter`` conditioner (``test_conditioner.py:178``),
  and streams a FIFO source through the scan receiver.
"""

import os
import pickle
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.simulate.rf_scene import generate_scene
from gnss_sdr_tpu_torch.simulate.scenario import (make_constellation,
                                                  rx_position, visible_sats)

torch.set_num_threads(2)
FS = 2.5e6
TOE = 7200.0
BITS_START = 7200.0 + 598 * 6.0
T_START = BITS_START + 4.5
DURATION = 9.8


def _config_kwargs():
    return dict(fs=FS, n_channels=5, acq_pfa=0.001, acq_dwells=2,
                output_rate_ms=100, pull_in_time_s=0.4,
                extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
                dll_bw_narrow_hz=0.75, enable_carrier_smoothing=True,
                smoothing_factor=100)


def _shared(tmp_path_factory, name, build):
    """``build()``'s result, computed once per test run: under xdist the
    first worker to get here builds and pickles it into the run's common
    temporary root, and the others wait for the file."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / name
    try:
        os.close(os.open(path.with_suffix(".lock"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + 300.0
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.5)
        with open(path, "rb") as fh:
            return pickle.load(fh)
    value = build()
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(value, fh)
    os.replace(tmp, path)
    return value


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene, generated once per test run."""
    rx = rx_position()
    ephs = make_constellation(range(1, 13), toe_s=TOE)
    prns = visible_sats(ephs, rx, T_START)[:5]
    assert len(prns) >= 5
    x = _shared(tmp_path_factory, "torch_l1_scene_31.pkl",
                lambda: generate_scene(ephs, prns, rx, T_START, DURATION, FS,
                                       bits_start_tow_s=BITS_START,
                                       n_subframes=4, cn0_db_hz=48.0,
                                       seed=31))
    return x, ephs, prns, rx


@pytest.fixture(scope="module")
def port_run(scene, tmp_path_factory):
    """The port's production receiver over the scene, run once per test
    run: what the tests read of it (fixes, mode, handoff, timings,
    channel states)."""
    from gnss_sdr_tpu_torch.receiver.production import ProductionReceiver
    from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig

    def run():
        x, ephs, prns, _ = scene
        rec = ProductionReceiver(ReceiverConfig(**_config_kwargs()),
                                 satellites=list(prns),
                                 assisted_ephemeris={p: ephs[p]
                                                     for p in prns},
                                 device="cpu")
        rec.run(x)
        return types.SimpleNamespace(
            solutions=rec.solutions, in_fast_mode=rec.in_fast_mode,
            handoff_sample=rec.handoff_sample, timings=rec.timings,
            channel_states=rec.receiver.channel_states())

    return _shared(tmp_path_factory, "torch_l1_port_run_31.pkl", run)


def test_port_production_fast_phase_fix(scene, port_run):
    rec = port_run
    rx = scene[3]
    sols = rec.solutions
    assert rec.in_fast_mode, "never handed off to the fast engine"
    assert rec.handoff_sample < FS * 4.0
    assert len(sols) >= 5, f"got {len(sols)} fixes"
    tail = sols[len(sols) // 2:]
    mean_err = float(np.mean([np.linalg.norm(s.pos_ecef - rx)
                              for s in tail]))
    assert mean_err < 5.0, f"mean 3D error {mean_err} m"
    from gnss_sdr_tpu_torch.receiver.fsm import ChannelState

    states = rec.channel_states
    assert sum(s is ChannelState.TRACKING for s in states) >= 5
    assert rec.timings["phase_b_samples"] > rec.timings["phase_a_samples"]


def test_port_matches_jax_receiver(scene, port_run):
    from gnss_sdr_tpu.receiver import ReceiverConfig as JConfig
    from gnss_sdr_tpu.receiver.production import ProductionReceiver as JRec

    x, ephs, prns, rx = scene
    jrec = JRec(JConfig(**_config_kwargs()), satellites=list(prns),
                assisted_ephemeris={p: ephs[p] for p in prns})
    jrec.run(x)
    assert jrec.in_fast_mode and port_run.in_fast_mode
    assert port_run.handoff_sample == jrec.handoff_sample
    fj = {round(s.rx_tow_s, 3): s.pos_ecef for s in jrec.solutions}
    ft = {round(s.rx_tow_s, 3): s.pos_ecef for s in port_run.solutions}
    common = sorted(set(fj) & set(ft))
    assert len(common) >= 5, (sorted(fj), sorted(ft))
    diffs = [float(np.linalg.norm(fj[t] - ft[t])) for t in common]
    assert max(diffs) < 1.0, diffs


CONF = """
GNSS-SDR.internal_fs_sps=2500000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={filename}
SignalSource.item_type=gr_complex
Channels_1C.count=5
Channels_1C.satellites={sats}
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.doppler_max=4000
Acquisition_1C.doppler_step=250
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Tracking_1C.pull_in_time_s=0.4
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
GNSS-SDR.AGNSS_gps_ephemeris_xml={agnss}
"""


def test_cli_production_fast_mode_fix_cpu(scene, tmp_path, capsys):
    """``python -m gnss_sdr_tpu_torch -c rx.conf --device cpu`` runs the
    production fast path and prints GGA fixes."""
    import gnss_sdr_tpu_torch.__main__ as cli
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml

    x, ephs, prns, _ = scene
    cap = tmp_path / "scene.dat"
    x[:int(8.4 * FS)].astype(np.complex64).tofile(cap)
    agnss = save_ephemeris_xml({p: ephs[p] for p in prns},
                               tmp_path / "gps_ephemeris.xml")
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(
        filename=cap, agnss=agnss, sats=",".join(str(p) for p in prns))))
    kml = tmp_path / "track.kml"
    rc = cli.main(["-c", str(conf), "--device", "cpu", "--kml", str(kml)])
    captured = capsys.readouterr()
    assert rc == 0
    assert cli.last_receiver.in_fast_mode
    assert "engine=production fast_mode=True" in captured.err
    fixes = [ln for ln in captured.out.splitlines()
             if ln.startswith("$GPGGA")]
    assert len(fixes) >= 5, captured.err
    assert b"</kml>" in kml.read_bytes()


def _upsample_to_if(x):
    """The scene at twice its rate (spectrum zero-padded) shifted up by a
    quarter of the new rate (1.25 MHz at 5 Msps), as complex64."""
    n = len(x)
    spec = torch.fft.fft(torch.from_numpy(x.astype(np.complex64)))
    up = torch.zeros(2 * n, dtype=torch.complex64)
    up[:n // 2] = 2 * spec[:n // 2]
    up[-(n - n // 2):] = 2 * spec[n // 2:]
    y = torch.fft.ifft(up)
    rot = torch.tensor([1, 1j, -1, -1j], dtype=torch.complex64)
    return (y * rot[torch.arange(2 * n) % 4]).numpy()


COND_CONF = """
SignalSource.implementation={source}
SignalSource.sampling_frequency=5000000
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Pass_Through
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.IF=1250000
InputFilter.decimation_factor=2
InputFilter.number_of_taps=33
"""


def _cond_conf(tmp_path, scene, seconds, source="File_Signal_Source"):
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml

    x, ephs, prns, _ = scene
    cap = tmp_path / "if_capture.dat"
    _upsample_to_if(x[:int(seconds * FS)]).tofile(cap)
    agnss = save_ephemeris_xml({p: ephs[p] for p in prns},
                               tmp_path / "gps_ephemeris.xml")
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(
        filename=cap, agnss=agnss, sats=",".join(str(p) for p in prns)))
        + textwrap.dedent(COND_CONF.format(source=source)))
    return conf


def test_cli_conditioned_if_capture_cpu(scene, tmp_path, capsys):
    """The shared scene at 5 Msps and an IF of 1.25 MHz (the conf of
    tests/test_conditioner.py:191-232: 33 taps, D = 2) through the CLI:
    fast mode, >= 4 GGA fixes, mean error < 5 m against the truth."""
    import gnss_sdr_tpu_torch.__main__ as cli

    conf = _cond_conf(tmp_path, scene, 8.4)
    rc = cli.main(["-c", str(conf), "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "engine=production fast_mode=True" in captured.err
    sols = cli.last_receiver.solutions
    fixes = [ln for ln in captured.out.splitlines()
             if ln.startswith("$GPGGA")]
    assert len(fixes) >= 4 and len(fixes) == len(sols), captured.err
    err = np.mean([np.linalg.norm(s.pos_ecef - scene[3]) for s in sols])
    assert err < 5.0, err


def test_cli_streams_a_fifo_source_cpu(scene, tmp_path, capsys):
    """A FIFO source (a file standing in for the pipe) through the CLI's
    streaming branch: raw chunks of one second, apply_stream, and the
    scan receiver block by block until the writer is gone."""
    import gnss_sdr_tpu_torch.__main__ as cli
    from gnss_sdr_tpu_torch.receiver.fsm import ChannelState

    conf = _cond_conf(tmp_path, scene, 1.0, source="Fifo_Signal_Source")
    rc = cli.main(["-c", str(conf), "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "engine=scan" in captured.err
    # one raw second (5 M samples) -> 2.5 M conditioned samples
    rec = cli.last_receiver
    blocks = (int(FS) - rec.overlap) // rec.block_samples
    assert f"processed {blocks * rec.block_samples} samples" in captured.err
    states = rec.channel_states()
    assert sum(s is ChannelState.TRACKING for s in states) >= 4, states


def test_cli_missing_source_is_an_error(tmp_path):
    import gnss_sdr_tpu_torch.__main__ as cli

    conf = tmp_path / "bad.conf"
    conf.write_text("GNSS-SDR.internal_fs_sps=2500000\n")
    assert cli.main(["-c", str(conf), "--device", "cpu"]) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-c", str(conf), "--telecommand_port", "2101"])


def test_factory_scan_engine_and_todo_branches(tmp_path):
    from gnss_sdr_tpu_torch.config import InMemoryConfiguration
    from gnss_sdr_tpu_torch.receiver.factory import (make_receiver,
                                                     make_signal_source)
    from gnss_sdr_tpu_torch.receiver.production import ProductionReceiver
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver

    cfg = InMemoryConfiguration()
    cfg.set_property("GNSS-SDR.internal_fs_sps", "2500000")
    cfg.set_property("Channels_1C.count", "2")
    assert isinstance(make_receiver(cfg, device="cpu"), ProductionReceiver)
    cfg.set_property("GNSS-SDR.engine", "scan")
    assert type(make_receiver(cfg, device="cpu")) is Receiver
    cfg.set_property("Tracking_1C.implementation", "Nope")
    with pytest.raises(ValueError, match="supported"):
        make_receiver(cfg, device="cpu")
    for key, value in (("Channels_L5.count", "4"),
                       ("PVT.positioning_mode", "PPP_Static")):
        c2 = InMemoryConfiguration()
        c2.set_property(key, value)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_receiver(c2, device="cpu")
    # the live sources are ported: a FIFO source opens its pipe lazily
    from gnss_sdr_tpu_torch.sources import FifoSignalSource

    c3 = InMemoryConfiguration()
    c3.set_property("SignalSource.implementation", "Fifo_Signal_Source")
    assert isinstance(make_signal_source(c3), FifoSignalSource)
    c3.set_property("SignalSource.implementation", "Nope_Signal_Source")
    with pytest.raises(ValueError, match="supported"):
        make_signal_source(c3)
