"""The port's band scanner (``rtsdr_tpu_torch/pipeline/scan.py``) and the
CLI's ``--scan`` / ``--wideband-centers`` against the JAX package's on the
same bytes: K = 4 at MODE0 widths, three blocks.

Tolerances: the metrics are dB values of float32 powers; the two packages
sum in different orders, so RSSI agrees within 1e-3 dB and the PSD probes
(a maximum over bins minus a median over bins of a Bartlett average of
log-spectra) within 0.05 dB; the verdicts must be the same words.  The
``--scan`` table prints one decimal, so it is compared as text after the
numbers were found equal to 0.05 dB.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu import cli as jcli
from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import scan as jscan
from rtsdr_tpu_torch import cli as tcli
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline import scan as tscan
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
K, N_BLOCKS = 4, 3
WBS = K * MODE0.block_size


@pytest.fixture(scope="module")
def band():
    """Slot 1: a full station (stereo pilot detuned by +300 Hz, RDS); slot
    3: a mono-only carrier; slots 0 and 2 empty."""
    rng = np.random.default_rng(5)
    wave = signals.rds_baseband(signals.encode_rds_blocks(
        [int(w) for w in rng.integers(0, 1 << 16, 120)]))
    return signals.wideband_capture_iq(
        N_BLOCKS * MODE0.iq_len, K,
        {1: dict(rds_wave=wave, pilot_hz=19.3e3),
         3: dict(pilot_amp=0.0, stereo_amp=0.0, mono_amp=0.9)})


def _scan_both(band):
    t_init, t_step = tscan.make_band_scanner(MODE0, K, device="cpu")
    j_init, j_step = jscan.make_band_scanner(JMODE0, K)
    t_state, j_state = t_init(), j_init()
    t_acc, j_acc = [], []
    for b in range(N_BLOCKS):
        blk = band[b * WBS:(b + 1) * WBS]
        t_m, t_state = t_step(t_state, torch.as_tensor(blk))
        j_m, j_state = j_step(j_state, jnp.asarray(blk))
        t_acc.append(tscan.ScanMetrics(*(x.numpy() for x in t_m)))
        j_acc.append(jax.tree.map(np.asarray, j_m))
    return t_acc, j_acc, t_state, j_state


def test_scanner_metrics_and_verdicts_match_jax(band):
    t_acc, j_acc, t_state, j_state = _scan_both(band)
    for b, (t_m, j_m) in enumerate(zip(t_acc, j_acc)):
        assert isinstance(t_m, tscan.ScanMetrics)
        for name, tol in (("rssi_db", 1e-3), ("pilot_snr_db", 0.05),
                          ("rds_snr_db", 0.05)):
            t, j = getattr(t_m, name), getattr(j_m, name)
            assert t.shape == j.shape == (K,) and t.dtype == np.float32
            np.testing.assert_allclose(t, j, rtol=0, atol=tol,
                                       err_msg=f"block {b} {name}")
    assert np.array_equal(t_state.chan_zi.numpy(),
                          np.asarray(j_state.chan_zi))
    np.testing.assert_allclose(t_state.fe.zi_i.numpy(),
                               np.asarray(j_state.fe.zi_i), rtol=0, atol=1e-6)

    def mean(acc):
        return type(acc[0])(*(np.mean(np.stack(xs), axis=0)
                              for xs in zip(*acc[1:])))
    t_mean, j_mean = mean(t_acc), mean(j_acc)
    verdicts = tscan.classify(t_mean)
    assert verdicts == jscan.classify(j_mean)
    assert verdicts == ["empty", "station+stereo+rds", "empty", "station"]
    assert t_mean.rssi_db[1] > t_mean.rssi_db[0] + 20
    assert t_mean.pilot_snr_db[1] > t_mean.pilot_snr_db[3] + 6
    assert t_mean.rds_snr_db[1] > t_mean.rds_snr_db[3] + 6


def test_scan_state_carries_over_from_jax(band):
    """``state_from_numpy`` takes a ``ScanState``: the JAX scanner runs
    block 0, the port continues with block 1 from its state."""
    t_init, t_step = tscan.make_band_scanner(MODE0, K, device="cpu")
    j_init, j_step = jscan.make_band_scanner(JMODE0, K)
    _, j_state = j_step(j_init(), jnp.asarray(band[:WBS]))
    t_state = state_from_numpy(jax.tree.map(np.asarray, j_state),
                               device="cpu")
    assert isinstance(t_state, tscan.ScanState)
    assert isinstance(t_state.fe, type(t_init().fe))
    t_m, _ = t_step(t_state, torch.as_tensor(band[WBS:2 * WBS]))
    j_m, _ = j_step(j_state, jnp.asarray(band[WBS:2 * WBS]))
    np.testing.assert_allclose(t_m.rssi_db.numpy(), np.asarray(j_m.rssi_db),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_m.rds_snr_db.numpy(),
                               np.asarray(j_m.rds_snr_db), rtol=0, atol=0.05)


def test_median_and_classify_equal_numpy_and_jax(rng):
    for n in (5, 6, 413):
        x = rng.standard_normal((3, n)).astype(np.float32)
        np.testing.assert_array_equal(
            tscan._median(torch.as_tensor(x)).numpy(),
            np.median(x, axis=-1).astype(np.float32))
    m = tscan.ScanMetrics(rssi_db=np.array([-50.0, -10.0, -34.9, -35.1]),
                          pilot_snr_db=np.array([30.0, 7.9, 8.0, 30.0]),
                          rds_snr_db=np.array([30.0, 8.1, 2.0, 30.0]))
    assert tscan.classify(m) == jscan.classify(m) == [
        "empty", "station+rds", "station+stereo", "empty"]
    assert tscan.classify(m, rssi_floor_db=-60.0, snr_db=31.0) == [
        "station"] * 4
    with pytest.raises(ValueError, match="nfft too small"):
        tscan.make_band_scanner(MODE0, 2, nfft=16, device="cpu")


_XLA_LOG = re.compile(r"^[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+\s+\d+ \S+:\d+\] ")


def _cli(module, args, data, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", module, *args], input=data,
                         capture_output=True, cwd=cwd, env=env, timeout=600)
    err = [ln for ln in res.stderr.decode().splitlines()
           if not _XLA_LOG.match(ln)]
    return res.returncode, res.stdout.decode(), err


def test_cli_scan_table_equals_jax_cli(band, tmp_path):
    data = band.tobytes()
    ours = _cli("rtsdr_tpu_torch.cli",
                ["0", "--wideband", str(K), "--scan", "--device", "cpu"],
                data, tmp_path)
    theirs = _cli("rtsdr_tpu.cli", ["0", "--wideband", str(K), "--scan"],
                  data, tmp_path)
    assert ours[0] == theirs[0] == 0, (ours, theirs)
    assert ours[1] == theirs[1]
    lines = ours[1].splitlines()
    assert lines[0].split() == ["ch", "center", "RSSI", "dB", "pilot", "dB",
                                "RDS", "dB", "verdict"]
    assert [ln.split()[-1] for ln in lines[1:]] == [
        "empty", "station+stereo+rds", "empty", "station"]
    assert ours[2] == theirs[2] == [
        f"scanned {N_BLOCKS} wideband blocks x {K} channels"]
    # too short a capture, and --scan / --auto without --wideband
    for args, data_ in ((["0", "--wideband", str(K), "--scan"],
                         data[:WBS]),
                        (["0", "--scan"], b""), (["0", "--auto"], b"")):
        a = _cli("rtsdr_tpu_torch.cli", args + ["--device", "cpu"], data_,
                 tmp_path)
        b = _cli("rtsdr_tpu.cli", args, data_, tmp_path)
        assert a[0] == b[0] == 1 and a[1] == b[1] == ""
        assert a[2] == b[2] and a[2][0].startswith("error: ")


@pytest.mark.parametrize("spec", [
    "+2.5M,-2.3M", "-4.7M", "4.9M", "2.3M,2.5M", "oops", "+1.15M", "+1.0M",
    "150k, ,-2400000", ""])
def test_centers_to_offsets_equals_jax(spec):
    """Offsets and error texts of ``--wideband-centers``, word for word,
    where each centre claims a slot of its own (the port's stations, one a
    centre, put in their slots give the JAX package's per-slot offsets).
    Two centres in one slot, which the JAX package refuses, are two
    stations of that slot in the port."""
    t_slots, t_off, t_err = tcli._centers_to_offsets(MODE0, 4, spec)
    j_off, j_err = jcli._centers_to_offsets(JMODE0, 4, spec)
    if j_err is not None and "both map to" in j_err:
        assert t_err is None
        assert t_slots == [1, 1] and np.array_equal(t_off, [-100e3, 100e3])
        return
    assert t_err == j_err
    if j_err is None:
        per_slot = np.zeros(4)
        per_slot[t_slots] = t_off
        assert len(set(t_slots)) == len(t_slots)
        assert np.array_equal(per_slot, j_off)
    else:
        assert t_slots is None and t_off is None
    for s in ("98.1M", "-200k", "150000", " 7K "):
        assert tcli._parse_freq(s) == jcli._parse_freq(s)
