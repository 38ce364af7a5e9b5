"""``tools/torch_comm_model.py``: the spread route's hand-overs per step,
derived from the port's configuration, held against what the route really
hands over and against the JAX tool's inventory (``tools/comm_model.py``).

The model's bytes and moves per step must equal those that pass through
``utils/shards.py::move`` in one step of a spread mesh on the CPU (counted
through a hook), and its cross-device bytes those of every move but the
ones between the row's home and shard 0.  Per channel and interior
boundary, the items both tools count equal the JAX tool's
``timeshard_traffic``; the others are named in ``DIFFERS_FROM_JAX``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rtsdr_tpu import config as jconfig
from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS
from rtsdr_tpu_torch.parallel import timeshard
from rtsdr_tpu_torch.parallel.mesh import make_mesh
from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu_torch.utils.shards import Place
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import comm_model  # noqa: E402
import torch_comm_model as tcm  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("cfg,jcfg,differ", [
    (MODE0, jconfig.MODE0,
     {"pilot_zi", "chan_zi", "extract_zi", "resampler_tail", "rrc_zi"}),
    (MODE1_RDS, jconfig.MODE1_RDS,
     {"pilot_zi", "chan_zi", "extract_zi", "resampler_tail", "rrc_zi",
      "mono_tail", "stereo_mixed_tail"}),
], ids=["MODE0", "MODE1_RDS"])
def test_shared_items_equal_the_jax_tool(cfg, jcfg, differ):
    jax_items = comm_model.timeshard_traffic(jcfg)["ppermute_bytes"]
    port = tcm.spread_traffic(cfg, 3, 4)["per_boundary_bytes_per_channel"]
    shared = {k for k in jax_items if k in port}
    assert shared == set(jax_items) - differ
    for k in shared:
        assert port[k] == jax_items[k], k
    assert differ <= set(tcm.DIFFERS_FROM_JAX)
    # what the differing items are, in the JAX tool's terms
    assert port["if_bank_tail"] == jax_items["pilot_zi"]
    assert port["resampler_mixed_tail"] == 2 * jax_items["resampler_tail"]
    assert port["rrc_tail"] == 2 * jax_items["rrc_zi"]
    if cfg.mono.up > 1:
        assert port["mono_stereo_pair_tail"] == (
            jax_items["mono_tail"] + jax_items["stereo_mixed_tail"])
    # the port hands the PLL state (7 leaves, 2 loops) on under 'exact'
    assert port["pll_handoff"] == 7 * 2 * 4


CASES = {
    "MODE0-exact-fused-C2-T4": (MODE0, 2, 4, dict(ingest_impl="fused")),
    "MODE0-stale-split-blend-T2": (
        MODE0, 1, 2, dict(pll_handoff="stale", stereo_blend=True)),
    "MODE0-iterate-split-T4": (MODE0, 1, 4, dict(pll_handoff="iterate")),
    "MODE0-audio-T4": (MODE0, 1, 4, dict(enable_rds=False)),
    "MODE1_RDS-exact-fused-T4": (MODE1_RDS, 1, 4, dict(ingest_impl="fused")),
    "MODE1-T2": (MODE1, 1, 2, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_the_moves_of_one_step(case, monkeypatch):
    cfg, c, t_shards, kw = CASES[case]
    places = tuple(Place(CPU) for _ in range(t_shards))   # told apart by id
    monkeypatch.setattr(timeshard, "time_shard_places", lambda devs: places)
    seen = []
    real = timeshard.move

    def counted(x, src, dst):
        own = [any(p is q for q in places) for p in (src, dst)]
        local = ((src is places[0] and not own[1])
                 or (dst is places[0] and not own[0]))
        seen.append((x.numel() * x.element_size(), local))
        return real(x, src, dst)

    monkeypatch.setattr(timeshard, "move", counted)
    init, step = make_time_sharded_receiver(
        cfg, make_mesh(1, t_shards, devices=["cpu"] * t_shards), c,
        jit=False, **kw)
    raw = np.stack([fm_multiplex_iq(cfg.iq_len, cfg.rf.fs)] * c)
    step(init(), torch.as_tensor(raw))
    model = tcm.spread_traffic(
        cfg, c, t_shards, kw.get("pll_handoff", "exact"),
        kw.get("ingest_impl", "split"), enable_rds=kw.get("enable_rds"),
        stereo_blend=kw.get("stereo_blend", False))
    assert model["moves_per_step"] == len(seen)
    assert model["bytes_per_step"] == sum(b for b, _ in seen)
    assert model["cross_device_bytes_per_step"] == sum(
        b for b, local in seen if not local)


def test_prediction_from_a_profile_file(tmp_path, capsys):
    """Step and PLL times from a profile tool's JSON line; the link
    bandwidth is the caller's; without them no prediction is made."""
    prof = {"device_busy_ms_per_step": 3.0,
            "by_kernel": {"void pll_kernel<1>(Parts, ...)":
                          {"ms_per_step": 0.4, "calls_per_step": 1},
                          "ingest_kernel": {"ms_per_step": 0.8,
                                            "calls_per_step": 1}}}
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(prof))
    assert tcm.profile_times(str(path)) == (3.0, 0.4)
    tcm.main(["--channels", "8", "--time-shards", "4", "--profile",
              str(path), "--link-gbps", "50"])
    out = json.loads(capsys.readouterr().out)
    tr = tcm.spread_traffic(MODE0, 8, 4)
    comm = tr["cross_device_bytes_per_step"] / 50e9 * 1e3
    assert out["prediction"]["predicted_step_ms"] == pytest.approx(
        2.6 / 4 + 0.4 + comm)
    tcm.main(["--channels", "8", "--handoff", "stale"])
    out = json.loads(capsys.readouterr().out)
    assert out["prediction"].startswith("none")
    assert out["bytes_per_step"] == tcm.spread_traffic(
        MODE0, 8, 4, "stale")["bytes_per_step"]
