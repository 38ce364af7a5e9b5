"""``tools/torch_pll_envelope.py`` against the same computation through the
JAX package (CPU).

A reduced grid (2 detunes x 2 SNRs, ``loop_div`` 1 and 4, 2 blocks) of both
PLL instances: the tool's signals (its own noise draws) go through the
tool's batched ``fir_block`` + ``pll`` on the port's plain versions, and
through ``rtsdr_tpu.ops.fir.fir_block`` + ``rtsdr_tpu.ops.pll.pll(
loop_div=...)`` called here; both NCO outputs are read by the tool's own
``lock_jitter``.  Tolerances: lock amplitude and RMS jitter within 2e-3
(the two float32 loops agree to ~1e-6 once locked and part by ~1e-3 while
acquiring from the zero state), the settle block equal.  Jitter is compared
where the loop holds a phase (lock amplitude above ``PHASE_HELD``): a loop
that has not acquired averages its rotating phasor to ~0, and the angle
about that mean is spread uniformly whatever its rounding.  The JAX tool is
not imported: it sets a compilation cache when imported.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import coeffs as j_coeffs
from rtsdr_tpu.ops.fir import fir_block as j_fir_block
from rtsdr_tpu.ops.fir import fir_zi as j_fir_zi
from rtsdr_tpu.ops.pll import pll as j_pll
from rtsdr_tpu.ops.pll import pll_init as j_pll_init

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import torch_pll_envelope as pe  # noqa: E402

torch.set_num_threads(1)

BLOCKS = 2
DIVS = (1, 4)
DETUNES = {"stereo": np.array([-200.0, 0.0]),
           "rds": np.array([-500.0, 0.0])}
SNRS = (np.inf, 10.0)
TOL_LOCK = 2e-3
TOL_JITTER = 2e-3
PHASE_HELD = 0.5


def _jax_records(name, spec, grid, sig, div):
    lo, hi, taps = spec["bpf"]
    h = j_coeffs.bandpass_taps(pe.FS, lo, hi, taps)
    c = len(grid)
    zi = j_fir_zi(taps, (c,), jnp.float32)
    st = j_pll_init((c,), jnp.float32)
    locks = np.zeros((BLOCKS, c))
    jitters = np.zeros((BLOCKS, c))
    for b in range(BLOCKS):
        filt, zi = j_fir_block(jnp.asarray(sig[:, b * pe.N:(b + 1) * pe.N]),
                               h, zi)
        ni, nq, st = j_pll(filt, st, freq=spec["f0"], fs=pe.FS,
                           nco_scale=spec["nco_scale"],
                           norm_bandwidth=spec["bw"], impl="auto",
                           loop_div=div)
        locks[b], jitters[b] = pe.lock_jitter(np.asarray(ni), np.asarray(nq),
                                              b, grid, spec)
    return pe.records(name, div, grid, locks, jitters)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(pe.SEED)
    out = {}
    for name, spec in pe.INSTANCES.items():
        grid, sig = pe.grid_signals(spec, rng, BLOCKS, DETUNES[name], SNRS)
        port = pe.run_instance(name, spec, grid, sig, DIVS, "cpu")
        out[name] = {div: (port[div], _jax_records(name, spec, grid, sig, div))
                     for div in DIVS}
    return out


@pytest.mark.parametrize("name", list(pe.INSTANCES))
@pytest.mark.parametrize("div", DIVS)
def test_envelope_equals_jax(both, name, div):
    port, ref = both[name][div]
    assert len(port) == len(ref) == len(DETUNES[name]) * len(SNRS)
    for p, r in zip(port, ref):
        assert (p["pll"], p["div"], p["detune_hz"], p["snr_db"]) == \
            (r["pll"], r["div"], r["detune_hz"], r["snr_db"])
        assert abs(p["lock"] - r["lock"]) <= TOL_LOCK, (p, r)
        if min(p["lock"], r["lock"]) > PHASE_HELD:
            assert abs(p["jitter_rad"] - r["jitter_rad"]) <= TOL_JITTER, \
                (p, r)
        assert p["settle_block"] == r["settle_block"], (p, r)


def test_clean_centre_point_locks_at_div1(both):
    for name in pe.INSTANCES:
        port, _ = both[name][1]
        (centre,) = [p for p in port
                     if p["detune_hz"] == 0.0 and p["snr_db"] is None]
        assert centre["lock"] > pe.SETTLE and centre["settle_block"] >= 0


def test_summary_fields(both):
    res = {name: {div: both[name][div][0] for div in DIVS} for name in both}
    rows = pe.summary(res)
    assert [(r["summary"], r["div"]) for r in rows] == [
        ("stereo", 4), ("rds", 4)]
    for r in rows:
        assert set(r) == {"summary", "div", "max_lock_drop",
                          "max_jitter_increase_rad",
                          "max_settle_delay_blocks", "lock_state_flips"}
