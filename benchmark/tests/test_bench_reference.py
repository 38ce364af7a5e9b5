"""The frozen reference (``benchmark/reference/golden.py``) against the
golden decoder of ``tests/torch_oracles.py``, and against the port run in
float64 on the CPU, from its initial state and from the port's state in
the middle of a stream (the window items' hand-over)."""

import os
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import check, core
from benchmark.reference import golden
from benchmark.traffic import synth
from conftest import ROOT, SMALL

NAMES = ["A", "B", "C", "D", "C'"]


def _stream(config_name, n_blocks, seed=3):
    tr = {**core.load_json(core.BENCH_DIR, "traffic", "ring1024.json"),
          **SMALL, "ring_blocks": n_blocks}
    cfg = core.load_json(core.BENCH_DIR, "configs", config_name + ".json")
    ring, *_ = synth.make_ring(tr, cfg, seed)
    return cfg, ring[0].reshape(-1)


def test_equals_torch_oracles_mode0():
    """Audio, RRC output and sync events as the golden decoder gives them.
    The golden discriminator takes the phase of an I/Q sample of exactly
    (0, 0) as 0 where the reference's (the port's) takes the phase step
    from it as 0: they differ at a stream's second IF sample only (behind
    the RF filter's zero first tap), so the RDS chain is compared over the
    reference's own discriminator output, and the audio, whose PLL carries
    the start, from the second block on.  The golden PLL also takes an
    input of exactly 0 literally (atan2(-0, -0) kicks it by pi), which the
    port, and so the reference, does not: the RDS chain's first samples
    are zeros, so its first block differs too, and everything is compared
    from the second block on."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_oracles as orc

    n = 4
    cfg, iq = _stream("mode0", n)
    cfg = {**cfg, "receiver": {**cfg["receiver"], "resync": False}}
    gold = orc.golden_mono_stereo(iq, n)
    rx = golden.Receiver(cfg)
    st = rx.init(1)
    bs = cfg["block_size"]
    fm_blocks, outs = [], []
    prev = (np.ones(1), np.zeros(1))
    for b in range(n):
        raw = iq[None, b * bs:(b + 1) * bs]
        x = (raw.astype(np.float64) - 128.0) / 128.0
        i_if, _ = rx.rf(st["rf_i"], x[:, 0::2])
        q_if, _ = rx.rf(st["rf_q"], x[:, 1::2])
        ip = np.concatenate([prev[0][:, None], i_if[:, :-1]], -1)
        qp = np.concatenate([prev[1][:, None], q_if[:, :-1]], -1)
        fm_blocks.append(np.arctan2(q_if * ip - i_if * qp,
                                    i_if * ip + q_if * qp)[0])
        prev = (i_if[:, -1], q_if[:, -1])
        st, out = rx.step(st, x[:, 0::2], x[:, 1::2])
        outs.append(out)
    rds = orc.golden_rds_dsp(fm_blocks)
    dec = orc.GoldenFrameDecoder(offset_mode="hold")
    for b in range(n):
        out = outs[b]
        _, events = dec.step(*rds[b])
        if b == 0:
            continue
        np.testing.assert_allclose(out["rrc_i"][0], rds[b][0], rtol=0,
                                   atol=1e-9)
        f = out["frame"][0]
        ours = [(NAMES[f["syndrome_id"][w] - 1], int(f["positions"][w]),
                 bool(f["is_sync"][w]))
                for w in range(f["n_windows"]) if f["syndrome_id"][w]]
        assert ours == [(n_, int(p), bool(s)) for n_, p, s in events]
        a = slice(b * 3072, (b + 1) * 3072)
        for ch in ("left", "right"):
            np.testing.assert_allclose(out[ch][0], gold[ch][a], rtol=0,
                                       atol=1e-9)
    assert sum(s for *_, s in ours) > 0


@pytest.mark.parametrize("config_name", ["mode0", "mode1_rds"])
def test_equals_the_port_in_float64(config_name):
    """From the initial state, every block; and a window item: the
    reference's hand-over from the port's state before blocks s - 1 and
    s gives block s as the port computed it."""
    from rtsdr_tpu_torch.pipeline.receiver import make_receiver

    torch.set_num_threads(2)
    n = 5
    cfg, iq = _stream(config_name, n, seed=11)
    bs = cfg["block_size"]
    blocks = iq.reshape(n, 1, bs)
    pcfg = core.port_config(cfg)
    init_fn, step = make_receiver(pcfg, (1,), torch.float64, device="cpu",
                                  **core.receiver_kwargs(cfg))
    state, outs, snaps = init_fn(), [], []
    for b in range(n):
        snaps.append(check.to_host(check.state_rows(state, 0)))
        state, out = step(state, torch.as_tensor(blocks[b]))
        outs.append({"left": out.left[0].numpy(),
                     "right": out.right[0].numpy(),
                     "frame": check.frame_dict(
                         type(out.rds)(*(t.numpy() for t in out.rds)), 0)})
    items = [{"kind": "start", "stream": 0, "blocks": list(range(n)),
              "outputs": outs},
             {"kind": "window", "stream": 0, "blocks": [n - 1],
              "outputs": [outs[n - 1]], "snap_prev": snaps[n - 2],
              "snap_at": snaps[n - 1]}]
    refs = check.reference(cfg, "float64", lambda c, b: blocks[b, 0], items)
    numbers = check.compare(items, refs)
    assert numbers["mono_err"] < 1e-9
    assert numbers["stereo_err"] < 1e-9
    assert numbers["symbol_err"] < 1e-9
    assert numbers["symbol_miss"] == 0
    assert numbers["frame_mismatch"] == 0
    assert sum(int(o["frame"]["is_sync"].sum()) for o in outs) > 5


def test_symbol_differences_up_to_the_carriers_sign():
    """The carrier's sign may differ for a whole block or turn over at a
    slip; a symbol of the wrong sign among its neighbours is a miss, and a
    block's head computed without its history misses too."""
    rng = np.random.default_rng(3)
    ref = rng.choice([-1.0, 1.0], 150) * rng.uniform(0.5, 1.0, 150)
    assert np.all(check.symbol_diffs(-ref, ref) == 0)
    slipped = ref.copy()
    slipped[70:] *= -1
    assert np.all(check.symbol_diffs(slipped, ref) == 0)
    flipped = ref.copy()
    flipped[[20, 21, 90]] *= -1
    d = check.symbol_diffs(flipped, ref)
    assert np.sum(d > check.MISS_AT) == 3
    head = ref.copy()
    head[:4] *= 0.5
    assert np.sum(check.symbol_diffs(head, ref) > check.MISS_AT) == 4


def _audio_item(left, right, ref_left, ref_right):
    frame = {"n_sym": 0, "symbols": np.zeros(0), "n_windows": 0,
             **{k: np.zeros(0, np.int64) for k in check.FRAME_KEYS}}
    item = {"kind": "window", "stream": 0, "blocks": [7],
            "outputs": [{"left": left, "right": right, "frame": frame}]}
    ref = [{"left": ref_left, "right": ref_right, "frame": frame,
            "frame_on_program": frame}]
    return check.compare([item], [ref])


def test_audio_numbers():
    """A stereo channel that departs for a few hundred samples, as the
    pilot loop does where rounding turns it, moves the median that
    ``stereo_err`` takes and not the mono; swapped channels move every
    stereo sample, and a block's head computed without its history the
    largest mono difference."""
    t = np.arange(3072) / 48e3
    mono = 0.45 * np.sin(2 * np.pi * 1234.0 * t)
    side = 0.45 * np.sin(2 * np.pi * 987.0 * t)
    left, right = mono + side, mono - side
    assert _audio_item(left, right, left, right) == {
        "mono_err": 0.0, "stereo_err": 0.0, "symbol_err": 0.0,
        "symbol_miss": 0.0, "frame_mismatch": 0.0}
    turned = side.copy()
    turned[1000:1400] += 7e-3 * np.exp(-np.arange(400) / 100.0)
    numbers = _audio_item(mono + turned, mono - turned, left, right)
    assert numbers["mono_err"] < 1e-15 and numbers["stereo_err"] == 0.0
    numbers = _audio_item(right, left, left, right)
    assert numbers["mono_err"] < 1e-15 and numbers["stereo_err"] > 0.1
    head = mono.copy()
    head[:30] *= 0.9
    numbers = _audio_item(head + side, head - side, left, right)
    assert numbers["mono_err"] > 1e-3 and numbers["stereo_err"] == 0.0
