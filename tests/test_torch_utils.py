"""The port's auxiliary modules against the JAX package's (CPU): signal
generators, ``log_vector`` / ``log_psd``, ``dft`` / ``magnitude``,
``stage_timings``, ``trace`` / ``annotate``, and the jax-free diagnostic
tools (``tools/torch_decode_campaign.py``'s synthesizer,
``tools/torch_constellation.py``, ``tools/torch_dump_diagnostics.py``).

Counterparts of ``tests/test_utils.py`` (generators, log round trip,
stage-timing smoke, trace helper; its checkpoint tests are in
``test_torch_checkpoint.py``) and of ``tests/test_misc_ops.py::
test_dft_matches_quadratic_definition``.
"""

import importlib
import json
import os
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.utils import logging as jlog
from rtsdr_tpu.utils import signals as jsig
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch import utils as tutils
from rtsdr_tpu_torch.utils import log_vector
from rtsdr_tpu_torch.utils.logging import log_psd
from rtsdr_tpu_torch.utils.signals import generate_sin, mix_sin, random_samples

torch.set_num_threads(1)
TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))


def test_utils_package_exports():
    """``rtsdr_tpu_torch.utils`` exports what ``rtsdr_tpu.utils`` does."""
    from rtsdr_tpu import utils as jutils
    from rtsdr_tpu_torch.utils import checkpoint

    for name in ("load_state", "save_state", "log_vector", "generate_sin",
                 "mix_sin", "random_samples"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name
    assert tutils.load_state is checkpoint.load_state


def test_generators():
    s1 = generate_sin(48e3, 1e3, 480)
    s2 = generate_sin(48e3, 2e3, 480)
    m = mix_sin(s1, s2)
    assert m.shape == (480,)
    np.testing.assert_allclose(m, (s1 + s2) / 2)
    np.testing.assert_array_equal(s1, jsig.generate_sin(48e3, 1e3, 480))
    np.testing.assert_array_equal(m, jsig.mix_sin(s1, s2))
    np.testing.assert_array_equal(random_samples(64, seed=3),
                                  jsig.random_samples(64, seed=3))


@pytest.mark.parametrize("kind", ["numpy", "tensor", "float32"])
def test_log_vector_roundtrip_and_bytes_equal_jax(tmp_path, kind):
    """The .dat round-trips, and is byte for byte JAX's file for the same
    values (a CPU tensor, or float32, in the port; numpy in JAX)."""
    y = np.linspace(0, 1, 10)
    x = np.arange(10) * 0.5
    if kind == "float32":
        y = y.astype(np.float32)
    arg = torch.as_tensor(y) if kind == "tensor" else y
    for xs in (None, x):
        ours = log_vector("probe", arg, xs, out_dir=str(tmp_path / "t"))
        ref = jlog.log_vector("probe", y, xs, out_dir=str(tmp_path / "j"))
        assert pathlib.Path(ours).read_bytes() == \
            pathlib.Path(ref).read_bytes()
        data = np.loadtxt(ours)
        np.testing.assert_allclose(data[:, 1], y, atol=1e-8)


def test_log_psd_matches_jax(tmp_path):
    """``log_psd`` over the port's ``estimate_psd``: the file's PSD equals
    JAX's within tests/test_psd.py's tolerance (rtol = atol = 1e-6 dB)."""
    x = generate_sin(48e3, 1e3, 2048)
    ours = np.loadtxt(log_psd("psd", x, 512, 48e3, out_dir=str(tmp_path)))
    ref = np.loadtxt(jlog.log_psd("psd", x, 512, 48e3,
                                  out_dir=str(tmp_path / "j")))
    assert ours.shape == ref.shape == (256, 2)
    np.testing.assert_array_equal(ours[:, 0], ref[:, 0])
    np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-6, atol=1e-6)
    t = log_psd("psd_t", torch.as_tensor(x), 512, 48e3,
                out_dir=str(tmp_path / "t"))
    np.testing.assert_array_equal(np.loadtxt(t), ours)


def test_dft_matches_quadratic_definition(rng):
    """Oracle: the O(N^2) DFT definition (reference src/fourier.cpp:15-23),
    and the JAX package's dft / magnitude on the same inputs."""
    from rtsdr_tpu.ops import fourier as jfourier
    from rtsdr_tpu_torch.ops import dft, magnitude

    n = 64
    x = rng.standard_normal(n)
    k = np.arange(n)
    ref = np.array([np.sum(x * np.exp(-2j * np.pi * k * m / n))
                    for m in range(n)])
    ours = dft(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-9)
    np.testing.assert_allclose(ours, np.asarray(jfourier.dft(jnp.asarray(x))),
                               atol=1e-9)
    mag = magnitude(torch.as_tensor(ref)).numpy()
    np.testing.assert_allclose(mag, np.abs(ref) / n, atol=1e-12)
    np.testing.assert_allclose(
        magnitude(torch.as_tensor(ref), normalize=False).numpy(),
        np.asarray(jfourier.magnitude(jnp.asarray(ref), normalize=False)),
        atol=1e-12)
    xb = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    np.testing.assert_allclose(dft(torch.as_tensor(xb)).numpy(),
                               np.asarray(jfourier.dft(jnp.asarray(xb))),
                               atol=1e-9)


def test_stage_timings_smoke(monkeypatch):
    """Same stages, names and record keys as the JAX package's table (its
    timing stubbed out: only its records are compared), finite times."""
    from rtsdr_tpu_torch.utils.profiling import stage_timings

    jprof = importlib.import_module("rtsdr_tpu.utils.profiling")
    monkeypatch.setattr(jprof, "_slope", lambda fn, args: 0.0)
    ref = jprof.stage_timings(MODE0, n_channels=2)
    recs = stage_timings(n_channels=2, device="cpu")
    assert [r["stage"] for r in recs] == [r["stage"] for r in ref]
    for r, j in zip(recs, ref):
        assert list(r) == list(j)
        assert r["channels"] == 2
        assert r["reference_note"] == j["reference_note"]
        assert np.isfinite(r["sec_per_block_batch"])
        assert r["sec_per_channel_block"] == r["sec_per_block_batch"] / 2


def test_profiling_cli_prints_one_record_per_stage(monkeypatch, capsys):
    prof = importlib.import_module("rtsdr_tpu_torch.utils.profiling")
    real = prof.stage_timings
    seen = {}

    def fake(n_channels, device):
        seen.update(n_channels=n_channels, device=device)
        return [{"stage": "a", "sec_per_block_batch": 1.0}, {"stage": "b"}]

    monkeypatch.setattr(prof, "stage_timings", fake)
    assert prof.main(["--channels", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(s)["stage"] for s in lines] == ["a", "b"]
    assert "card" not in json.loads(lines[0])
    assert seen == {"n_channels": 3, "device": "cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            real(n_channels=1)


def test_trace_helper(tmp_path):
    """``trace`` writes a Chrome trace file into its directory, and an
    ``annotate`` region shows up among its events."""
    from rtsdr_tpu_torch.utils.trace import annotate, trace

    with trace(str(tmp_path / "t")) as d:
        with annotate("probe_region"):
            _ = torch.ones(16).sum()
    assert d == str(tmp_path / "t")
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "probe_region" for e in events)


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    from rtsdr_tpu_torch.utils.trace import trace

    def refuse(self):
        raise RuntimeError("profiler refused")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    with pytest.raises(RuntimeError, match="profiler refused"):
        with trace(str(tmp_path / "t")):
            pass


def test_profile_tears_cupti_down_after_each_session(monkeypatch):
    """Every session of ``profile`` (and so of ``trace``) asks the profiler
    to tear CUPTI down at its end, unless the environment says otherwise;
    on the CPU it records the host alone."""
    from rtsdr_tpu_torch.utils.trace import profile

    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    with profile() as prof:
        _ = torch.ones(16).sum()
    assert os.environ["TEARDOWN_CUPTI"] == "1"
    assert prof.activities == {torch.profiler.ProfilerActivity.CPU}
    monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    profile()
    assert os.environ["TEARDOWN_CUPTI"] == "0"


# ------------------------------------------------------------- tools

def test_campaign_synthesizer_equals_the_jax_tools():
    """``torch_decode_campaign``'s own copy of the scenario table and the
    synthesizer gives the JAX tool's u8 stream for every scenario."""
    import decode_campaign as jdc
    import torch_decode_campaign as tdc

    assert tdc.SCENARIOS == jdc.SCENARIOS
    for name, sc in tdc.SCENARIOS.items():
        ours, n_ours = tdc.synth_impaired(2, sc)
        ref, n_ref = jdc.synth_impaired(2, sc)
        assert n_ours == n_ref, name
        assert ours.dtype == np.uint8 and np.array_equal(ours, ref), name


@pytest.mark.parametrize("kw", [
    {"quantize": False},
    {"ppm": -50.0, "pilot_hz": 19e3 + 200.0, "quantize": False},
    {"phase_noise_std": 3e-3, "pilot_drift_hz_per_s": 40.0,
     "carrier_offset_hz": 2e3, "pilot_phase": 0.3},
    {"rf_fs": 2.5e6, "mono_amp": 0.9, "stereo_amp": 0.0, "pilot_amp": 0.0},
], ids=["clean", "ppm_detune", "noise_drift_offset", "mode1_mono"])
def test_impaired_synthesizer_equals_the_oracle(kw):
    """The port's ``synth_multiplex_iq`` gives ``tests/oracles.py``'s
    stream value for value (float64 without quantization, u8 with it)."""
    import oracles
    from rtsdr_tpu_torch.utils import signals as tsig

    wave = tsig.rds_baseband(tsig.encode_rds_blocks(range(8)))
    ours = tsig.synth_multiplex_iq(20000, rds_wave=wave,
                                   rng=np.random.default_rng(3), **kw)
    ref = oracles.synth_multiplex_iq(20000, rds_wave=wave,
                                     rng=np.random.default_rng(3), **kw)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_tools_synthesize_without_jax(tmp_path):
    """The streams the card runs (the campaign's, ``--synth``'s) and the
    campaign's receiver pass import nothing of JAX or the JAX package: a
    fresh interpreter where both are unimportable builds them, and they
    equal the JAX tools' streams."""
    import subprocess

    import constellation as jcon
    import decode_campaign as jdc

    out = tmp_path / "streams.npz"
    code = f"""
import sys
sys.modules["jax"] = sys.modules["rtsdr_tpu"] = None
sys.path[:0] = [{str(TOOLS.parent)!r}, {str(TOOLS)!r}]
import numpy as np, torch
torch.set_num_threads(1)
import torch_constellation as tcon, torch_decode_campaign as tdc
import torch_dump_diagnostics
from rtsdr_tpu_torch.config import MODE0
streams = {{n: tdc.synth_impaired(1, tdc.SCENARIOS[n])[0]
           for n in ("phase_noise", "combined_harsh")}}
streams["station"] = tcon.synth_station(1, MODE0)
syncs, groups = tdc.receiver_yield(streams["combined_harsh"], 1,
                                   device="cpu")
assert (syncs, groups) == (0, 0), (syncs, groups)
np.savez({str(out)!r}, **streams)
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as got:
        for name in ("phase_noise", "combined_harsh"):
            ref, _ = jdc.synth_impaired(1, jdc.SCENARIOS[name])
            assert np.array_equal(got[name], ref), name
        assert np.array_equal(got["station"],
                              jcon._synth_station(1, MODE0))


def test_constellation_tool_recommends_the_jax_tools_phase(tmp_path, capsys,
                                                           monkeypatch):
    """``--synth 6``: the port tool's recommended phase_adjust equals the
    JAX tool's within 1e-3 rad (the JAX receiver run un-jitted)."""
    import constellation as jcon
    import torch_constellation as tcon

    assert tcon.main(["--synth", "6", "--sweep", "0", "--device", "cpu",
                      "--out", str(tmp_path / "t")]) == 0
    ours = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    assert jcon.main(["--synth", "6", "--sweep", "0",
                      "--out", str(tmp_path / "j")]) == 0
    ref = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert ours["n_symbols"] == ref["n_symbols"]
    assert abs(ours["recommended_phase_adjust"]
               - ref["recommended_phase_adjust"]) <= 1e-3, (ours, ref)
    assert ours["i_axis_concentration"] > 0.98
    assert (tmp_path / "t" / "constellation_tuned.dat").exists()
    # the analytic tuner recovers a phase deliberately set off by 0.5 rad
    base = MODE0.rds.pll.phase_adjust
    iq = tcon.synth_station(4, MODE0)
    si, sq = tcon.collect_symbols(iq, MODE0, 4, phase_adjust=base + 0.5,
                                  device="cpu")
    delta = tcon.optimal_phase_delta(si, sq)
    err = (delta + 0.5 + math.pi / 2) % math.pi - math.pi / 2
    assert abs(err) < 0.03, delta


def test_dump_diagnostics_tool_writes_the_probe_set(tmp_path):
    import torch_dump_diagnostics as tdd

    out = tmp_path / "data"
    assert tdd.main(["--synth", "3", "--device", "cpu", "--out",
                     str(out)]) == 0
    for name, rows in (("demod_psd", 256), ("audio_psd", 256), ("rrc", 512),
                       ("rrcQ", 512)):
        data = np.loadtxt(out / f"{name}.dat")
        assert data.shape == (rows, 2), name
    psd = np.loadtxt(out / "demod_psd.dat")
    pilot = np.abs(psd[:, 0] - 19e3) < 1e3
    assert psd[pilot, 1].max() > np.median(psd[:, 1]) + 20   # the pilot
    assert len((out / "constellation.dat").read_text().splitlines()) > 100
