"""``utils/jit.py::jit_fn``, the counterpart of ``jax.jit(fn)`` (no
donation), on the CPU, and its two callers: the CLI's band scanner loop
(``cli.py::_scan_band``, as the JAX CLI jits its scanner) and the stage
table (``utils/profiling.py``, as the JAX table jits each stage).

On the CPU a ``CompiledFn`` runs the function eagerly through its static
buffers, so the compiled scanner must equal the eager one bit for bit; the
scanner against the JAX package's has ``tests/test_torch_scan.py``'s
tolerances (RSSI 1e-3 dB, the PSD probes 0.05 dB: float32 sums in two
orders).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import scan as jscan
from rtsdr_tpu.utils import profiling as jprofiling
from rtsdr_tpu_torch import cli as tcli
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.pipeline import scan as tscan
from rtsdr_tpu_torch.utils import jit as jit_mod
from rtsdr_tpu_torch.utils import profiling as tprofiling
from rtsdr_tpu_torch.utils import signals
from rtsdr_tpu_torch.utils.jit import CompiledFn, jit_fn

torch.set_num_threads(1)

CPU = torch.device("cpu")
K, N_BLOCKS = 4, 3
WBS = K * MODE0.block_size


def _fn(state, x):
    """A small pure function of a tree and a tensor."""
    a, b = state
    return (a + x.sum(), b * 2.0), x[:2] * a[:2]


def _args():
    return ((torch.arange(3.0), torch.ones(2, 2)), torch.arange(4.0))


def test_repeated_calls_consume_nothing():
    f = jit_fn(_fn, CPU)
    assert isinstance(f, CompiledFn)
    args = _args()
    snap = [t.clone() for t in (*args[0], args[1])]
    first = f(*args)
    for _ in range(3):
        again = f(*args)
        for x, y in zip(jit_mod.flatten(first)[0], jit_mod.flatten(again)[0]):
            assert torch.equal(x, y)
    # the arguments are unchanged and usable
    for t, s in zip((*args[0], args[1]), snap):
        assert torch.equal(t, s)
    assert torch.equal(_fn(*args)[1], first[1])


def test_outputs_are_the_callers_own():
    f = jit_fn(_fn, CPU)
    args = _args()
    out = f(*args)
    keep = out[1].clone()
    out[1].fill_(-7.0)
    out[0][0].zero_()
    again = f(*args)
    assert torch.equal(again[1], keep)
    assert not torch.equal(again[0][0], out[0][0])


def test_new_values_of_the_same_shape_are_copied_in():
    f = jit_fn(_fn, CPU)
    (a, b), x = _args()
    f((a, b), x)
    got = f((a + 1.0, b), x * 3.0)
    ref = _fn((a + 1.0, b), x * 3.0)
    for g, r in zip(jit_mod.flatten(got)[0], jit_mod.flatten(ref)[0]):
        assert torch.equal(g, r)


def test_static_args_are_read_in_place():
    f = jit_fn(_fn, CPU)
    with pytest.raises(RuntimeError, match="not called"):
        f.static_args()
    f(*_args())
    state, x = f.static_args()
    x.copy_(torch.full((4,), 2.0))       # a caller writing its input
    _, y = f(state, x)
    assert torch.equal(y, _fn(_args()[0], torch.full((4,), 2.0))[1])


@pytest.mark.parametrize("change", ["shape", "dtype", "structure"])
def test_another_shape_raises(change):
    f = jit_fn(_fn, CPU, name="probe")
    (a, b), x = _args()
    f((a, b), x)
    bad = {"shape": ((a, b), torch.arange(5.0)),
           "dtype": ((a, b), torch.arange(4)),
           "structure": ((a, b, b), x)}[change]
    with pytest.raises(ValueError, match="probe"):
        f(*bad)


def test_replay_adds_the_recorded_launches():
    """As the donated step: the capture's launches are taken back out, each
    call adds what the capture recorded."""
    calls = []

    def fn(x):
        if not calls:
            _cuda.LAUNCHES["fake"] = _cuda.LAUNCHES.get("fake", 0) + 2
        calls.append(1)
        return x + 1

    saved = _cuda.launch_counts()
    _cuda.reset_launch_counts()
    try:
        f = jit_fn(fn, CPU)
        for k in range(3):
            f(torch.zeros(2))
            assert _cuda.launch_counts() == {"fake": 2 * (k + 1)}
        assert f.per_step == {"fake": 2}
    finally:
        _cuda.reset_launch_counts()
        _cuda.LAUNCHES.update(saved)


# ------------------------------------------------------ the band scanner
@pytest.fixture(scope="module")
def band():
    """Slot 1: a stereo RDS station; slot 3: a mono carrier."""
    rng = np.random.default_rng(7)
    wave = signals.rds_baseband(signals.encode_rds_blocks(
        [int(w) for w in rng.integers(0, 1 << 16, 120)]))
    return signals.wideband_capture_iq(
        N_BLOCKS * MODE0.iq_len, K,
        {1: dict(rds_wave=wave),
         3: dict(pilot_amp=0.0, stereo_amp=0.0, mono_amp=0.9)})


def test_scan_band_is_compiled_and_equals_eager_and_jax(band, tmp_path,
                                                        monkeypatch):
    path = tmp_path / "band.iq"
    band.tofile(path)
    made = []
    real = jit_mod.jit_fn
    monkeypatch.setattr(jit_mod, "jit_fn",
                        lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])
    with open(path, "rb") as f:
        monkeypatch.setattr(sys, "stdin", f)
        mean, verdicts, blocks = tcli._scan_band(MODE0, K, None, "cpu")
        assert f.read() == b""
    assert blocks == N_BLOCKS and len(made) == 1
    # every later block went into the compiled step's own input buffer
    assert made[0].static_args()[1].shape == (WBS,)

    # the eager scanner, and the JAX scanner un-jitted, over the same bytes
    t_init, t_step = tscan.make_band_scanner(MODE0, K, device="cpu")
    j_init, j_step = jscan.make_band_scanner(JMODE0, K)
    t_state, j_state = t_init(), j_init()
    t_acc, j_acc = [], []
    for b in range(N_BLOCKS):
        blk = band[b * WBS:(b + 1) * WBS]
        t_m, t_state = t_step(t_state, torch.as_tensor(blk))
        j_m, j_state = j_step(j_state, jnp.asarray(blk))
        if b:
            t_acc.append([x.numpy() for x in t_m])
            j_acc.append(jax.tree.map(np.asarray, j_m))
    eager = tscan.ScanMetrics(*(np.mean(np.stack(xs), axis=0)
                                for xs in zip(*t_acc)))
    j_mean = jax.tree.map(lambda *xs: np.mean(np.stack(xs), axis=0), *j_acc)
    for name, tol in (("rssi_db", 1e-3), ("pilot_snr_db", 0.05),
                      ("rds_snr_db", 0.05)):
        got = getattr(mean, name)
        assert np.array_equal(got, getattr(eager, name)), name
        np.testing.assert_allclose(got, getattr(j_mean, name), rtol=0,
                                   atol=tol, err_msg=name)
    assert verdicts == tscan.classify(eager) == jscan.classify(j_mean)
    assert verdicts[1].startswith("station+stereo") and verdicts[0] == "empty"


# ------------------------------------------------------- the stage table
def test_slope_times_the_compiled_stage(monkeypatch):
    made, calls = [], []
    real = tprofiling.jit_fn
    monkeypatch.setattr(tprofiling, "jit_fn",
                        lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])

    def stage(x):
        calls.append(x)
        return x * 2.0

    x = torch.ones(8)
    dt = tprofiling._slope(stage, (x,), CPU, "double", k1=1, k2=3,
                           repeats=1)
    assert isinstance(dt, float)
    assert len(made) == 1 and made[0].name == "double"
    # the capture, then 1 + 3 + 1 + 3 timed calls, every one over the
    # compiled stage's own argument buffer (no copy in)
    assert len(calls) == 9
    assert all(c is made[0].static_args()[0] for c in calls)


def test_stage_table_keeps_the_jax_tables_names_and_fields(monkeypatch):
    seen = {}

    def fake(pkg):
        def slope(fn, args, *a, **k):
            seen.setdefault(pkg, []).append(len(args))
            return 1e-3
        return slope

    monkeypatch.setattr(tprofiling, "_slope", fake("torch"))
    monkeypatch.setattr(jprofiling, "_slope", fake("jax"))
    t_recs = tprofiling.stage_timings(n_channels=2, device="cpu")
    j_recs = jprofiling.stage_timings(n_channels=2)
    assert [r["stage"] for r in t_recs] == [r["stage"] for r in j_recs]
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    assert seen["torch"] == seen["jax"]
