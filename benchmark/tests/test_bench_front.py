"""The check's reference front: the ``u8`` front gives, to the last bit,
what the golden receiver gave when it dequantized the bytes itself; a
front with state of its own is rebuilt for a window item as the filters
are; and a driver's row map picks each stream's row of a state with two
batch axes."""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import check, core, drive
from benchmark.reference import golden
from benchmark.traffic import synth
from conftest import SMALL


class ParentReceiver(golden.Receiver):
    """The golden receiver as it was before the front was split off: its
    ``step`` verbatim but for module-qualified names, u8 bytes in."""

    def step(self, state: dict, raw: np.ndarray, run: str = "full"):
        """One block of every lane.  ``run``: "full", "audio_rds" (all but
        the bit layer) or "front" (the stages before the PLLs only: their
        histories for the next block).  Returns ``(state, outputs)``."""
        q = lambda x: golden.to_precision(x, self.precision)  # noqa: E731
        s = dict(state)
        cfg = self.cfg
        iq = (raw.astype(np.float64) - 128.0) / 128.0
        i_if, s["rf_i"] = self.rf(state["rf_i"], iq[:, 0::2])
        q_if, s["rf_q"] = self.rf(state["rf_q"], iq[:, 1::2])
        ip = np.concatenate([state["prev_i"][:, None], i_if[:, :-1]], -1)
        qp = np.concatenate([state["prev_q"][:, None], q_if[:, :-1]], -1)
        fm = q(np.arctan2(q_if * ip - i_if * qp, i_if * ip + q_if * qp))
        s["prev_i"], s["prev_q"] = i_if[:, -1].copy(), q_if[:, -1].copy()
        mono, s["fm_audio"] = self.audio(state["fm_audio"], fm)
        pilot, _ = self.pilot(state["fm_if"], fm)
        chan, _ = self.chan(state["fm_if"], fm)
        extract, s["fm_if"] = self.extract(state["fm_if"], fm)
        pre_pll, s["extract_sq"] = self.squared(state["extract_sq"],
                                                q(extract * extract))
        if run == "front":
            return s, None
        st, r = cfg["stereo"], cfg["rds"]
        nco, _, s["pll_pilot"] = golden.pll(pilot, state["pll_pilot"],
                                            st["pll"]["freq"], self.if_fs,
                                            st["pll"], self.precision)
        stereo, s["mixed"] = self.audio(state["mixed"], q(2.0 * chan * nco))
        left = q(0.5 * (mono + stereo))
        right = q(0.5 * (mono - stereo))
        nco_i, nco_q, s["pll_rds"] = golden.pll(pre_pll, state["pll_rds"],
                                                r["pll"]["freq"], self.if_fs,
                                                r["pll"], self.precision)
        lpf_i, s["mix_i"] = self.lpf(state["mix_i"], q(extract * nco_i * 2))
        lpf_q, s["mix_q"] = self.lpf(state["mix_q"], q(extract * nco_q * 2))
        res_i, s["lpf_i"] = self.anti(state["lpf_i"], lpf_i)
        res_q, s["lpf_q"] = self.anti(state["lpf_q"], lpf_q)
        rrc_i, s["res_i"] = self.rrc(state["res_i"], res_i)
        rrc_q, s["res_q"] = self.rrc(state["res_q"], res_q)
        out = {"left": left, "right": right, "rrc_i": rrc_i, "rrc_q": rrc_q}
        if run == "full":
            frames, new = [], []
            for lane in range(len(raw)):
                o, f = golden.frame_block(rrc_i[lane], state["frame"][lane],
                                          r["sps"], self.resync)
                frames.append(o)
                new.append(f)
            s["frame"] = new
            out["frame"] = frames
        return s, out


def parent_reference(config, precision, block_of, items):
    """``check.reference`` as it was before the front was split off,
    verbatim but for the receiver's class."""
    rx = ParentReceiver(config, precision)
    out: list = [None] * len(items)
    start = [k for k, it in enumerate(items) if it["kind"] == "start"]
    if start:
        n_blocks = len(items[start[0]]["blocks"])
        st = rx.init(len(start))
        per = [[] for _ in start]
        for b in range(n_blocks):
            raw = np.stack([block_of(items[k]["stream"], b) for k in start])
            st, o = rx.step(st, raw)
            for lane in range(len(start)):
                per[lane].append({"left": o["left"][lane],
                                  "right": o["right"][lane],
                                  "frame": o["frame"][lane]})
        for lane, k in enumerate(start):
            out[k] = per[lane]
    window = [k for k, it in enumerate(items) if it["kind"] == "window"]
    if window:
        lanes = list(range(len(window)))
        its = [items[k] for k in window]

        def raw_at(back):
            return np.stack([block_of(it["stream"], it["blocks"][0] - back)
                             for it in its])
        st = rx.init(len(window))
        st, _ = rx.step(st, raw_at(2), run="front")
        check._inject(st, [it["snap_prev"] for it in its], "pll_pilot", lanes)
        check._inject(st, [it["snap_prev"] for it in its], "pll_rds", lanes)
        st, _ = rx.step(st, raw_at(1), run="audio_rds")
        check._inject(st, [it["snap_at"] for it in its], "frame", lanes)
        st, o = rx.step(st, raw_at(0))
        for lane, k in enumerate(window):
            out[k] = [{"left": o["left"][lane], "right": o["right"][lane],
                       "frame": o["frame"][lane]}]
    return check.on_outputs(items, out, rx.resync)


def _snap(state: dict, lane: int) -> dict:
    """The reference's state of one lane as a window item's host snapshot
    of the program's (``check.to_host(check.state_rows(...))``)."""
    snap = {key: {f: np.asarray(state[key][f][lane])
                  for f in golden.PLL_FIELDS}
            for key in ("pll_pilot", "pll_rds")}
    snap["frame"] = {f: np.asarray(state["frame"][lane][f])
                     for f in golden.FRAME_FIELDS}
    return snap


def _chain(config, front, block_of, streams, n_blocks):
    """The chained reference over ``streams`` from the initial state:
    each lane's snapshot before each block and its outputs of each
    block."""
    rx = golden.Receiver(config)
    fst, st = front.init(len(streams)), rx.init(len(streams))
    snaps, outs = [], []
    for b in range(n_blocks):
        snaps.append([_snap(st, lane) for lane in range(len(streams))])
        where = [(c, b) for c in streams]
        fst, i_rf, q_rf = front.step(fst, [block_of(c, b_) for c, b_ in
                                           where], where)
        st, o = rx.step(st, i_rf, q_rf)
        outs.append([{"left": o["left"][lane], "right": o["right"][lane],
                      "frame": o["frame"][lane]}
                     for lane in range(len(streams))])
    snaps.append([_snap(st, lane) for lane in range(len(streams))])
    return snaps, outs


def _block_of(config_name, seed=19):
    tr = {**core.load_json(core.BENCH_DIR, "traffic", "ring1024.json"),
          **SMALL}
    cfg = core.load_json(core.BENCH_DIR, "configs", config_name + ".json")
    ring, station, offset, *_ = synth.make_ring(tr, cfg, seed)
    return cfg, (lambda c, b: synth.stream_block(ring, station, offset, c,
                                                 b))


def _same(a, b) -> bool:
    """Equal to the last bit, through dicts and lists of arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


@pytest.fixture(scope="module", params=["mode0", "mode1_rds"])
def u8_items(request):
    """Both streams' first two blocks as start items, and a window item of
    each, at blocks 2 and 3, with the chained reference's states."""
    cfg, block_of = _block_of(request.param)
    assert "reference_front" not in cfg
    snaps, outs = _chain(cfg, check.load_front(cfg, "float64"), block_of,
                         [0, 1], 4)
    items = [{"kind": "start", "stream": c, "blocks": [0, 1],
              "outputs": [outs[b][c] for b in range(2)]} for c in (0, 1)]
    items += [{"kind": "window", "stream": c, "blocks": [s],
               "outputs": [outs[s][c]], "snap_prev": snaps[s - 1][c],
               "snap_at": snaps[s][c]} for c, s in ((0, 2), (1, 3))]
    return cfg, block_of, items


@pytest.mark.parametrize("precision", ["float64", "bfloat16"])
def test_u8_front_is_the_parents_reference_to_the_bit(u8_items, precision):
    cfg, block_of, items = u8_items
    new = check.reference(cfg, precision, block_of, items)
    old = parent_reference(cfg, precision, block_of, items)
    assert [len(r) for r in new] == [2, 2, 1, 1]
    assert _same(new, old)


class RotatingFir:
    """A front with state of its own, for the test: the u8 I/Q through a
    five-tap complex FIR whose last four inputs it carries, then rotated
    by ``ROT`` radians a sample of absolute time, the phase worked out
    from each lane's ``(stream, block)``."""

    H = np.array([0.1, -0.2, 0.9, 0.25, -0.05]) * np.exp(
        1j * np.arange(5) * 0.3)
    ROT = 2 * np.pi * 5e3 / 2.4e6

    def __init__(self, config, precision):
        self.n = config["block_size"] // 2

    def init(self, lanes):
        return np.zeros((lanes, len(self.H) - 1), complex)

    def step(self, state, raws, where):
        iq = (np.stack(raws).astype(np.float64) - 128.0) / 128.0
        x = np.concatenate([state, iq[:, 0::2] + 1j * iq[:, 1::2]], -1)
        y = sum(h * x[:, len(self.H) - 1 - k:x.shape[1] - k]
                for k, h in enumerate(self.H))
        n0 = np.array([b * self.n for _, b in where])[:, None]
        y = y * np.exp(1j * self.ROT * (n0 + np.arange(self.n)))
        return x[:, -(len(self.H) - 1):], y.real, y.imag


def test_a_front_with_state_is_rebuilt_for_a_window_item(monkeypatch):
    """A window item at block 4 rebuilt from blocks 2 and 3 through a
    front with a history and a phase of absolute time, with the chained
    run's PLL and bit-layer states injected, gives the chained
    reference's block 4 to the last bit; a start item through the same
    front gives the chain's blocks."""
    cfg, block_of = _block_of("mode0", seed=23)
    front = RotatingFir(cfg, "float64")
    snaps, outs = _chain(cfg, front, block_of, [1], 5)
    monkeypatch.setattr(check, "load_front", lambda config, precision:
                        RotatingFir(config, precision))
    s = 4
    items = [{"kind": "window", "stream": 1, "blocks": [s],
              "outputs": [outs[s][0]], "snap_prev": snaps[s - 1][0],
              "snap_at": snaps[s][0]},
             {"kind": "start", "stream": 1, "blocks": [0, 1],
              "outputs": [outs[b][0] for b in range(2)]}]
    refs = check.reference(cfg, "float64", block_of, items)
    for got, want in ((refs[0][0], outs[s][0]), (refs[1][1], outs[1][0])):
        assert _same({k: got[k] for k in want}, want)
        assert _same(got["frame_on_program"], want["frame"])
    assert outs[s][0]["frame"]["n_windows"] > 0
    # the rebuild is not trivially right: the unrotated u8 front parts
    monkeypatch.undo()
    plain = check.reference(cfg, "float64", block_of, items[:1])
    assert np.max(np.abs(plain[0][0]["left"] - outs[s][0]["left"])) > 1e-3


def _fake_state(k: int):
    """A state batched over (2 captures, 3 slots) whose every number says
    its step, capture and slot: ``100 k + 10 capture + slot``."""
    base = (100 * k + 10 * np.arange(2)[:, None] + np.arange(3)[None, :])

    def leaves(fields):
        return types.SimpleNamespace(**{
            f: torch.as_tensor(np.repeat(base[..., None], 27, -1)
                               if f == "carry" else base)
            for f in fields})
    return types.SimpleNamespace(
        audio=types.SimpleNamespace(pll=leaves(golden.PLL_FIELDS)),
        rds=types.SimpleNamespace(pll=leaves(golden.PLL_FIELDS)),
        frame=leaves(golden.FRAME_FIELDS))


def test_samples_take_each_streams_row_of_a_two_axis_state():
    rows = [(c // 3, c % 3) for c in range(6)]
    ctx = core.Ctx(cell={}, config={}, traffic={}, workload={"check": {
        "start_streams": 2, "start_blocks": 2, "window_items": 3,
        "pull_in_blocks": 0}}, seed=2**31 + 5, seconds=1.0, trace=False,
        device="cpu")
    samples = drive.Samples(ctx, 6, rows=rows)
    samples.start_window(0.0)
    for k in range(14):
        samples.before_step(k, _fake_state(k), 0.1 * k)
        samples.outputs(k, lambda row, k=k: {"row": row, "k": k})
    items = samples.finished()
    windows = [it for it in items if it["kind"] == "window"]
    assert len(windows) == 3
    assert {it["stream"] // 2 for it in windows} == {0, 1, 2}
    for it in items:
        cap, slot = rows[it["stream"]]
        assert [o["row"] for o in it["outputs"]] == [(cap, slot)] * len(
            it["blocks"])
        assert [o["k"] for o in it["outputs"]] == it["blocks"]
    for it in windows:
        cap, slot = rows[it["stream"]]
        (s,) = it["blocks"]
        for key, k in (("snap_prev", s - 1), ("snap_at", s)):
            want = 100 * k + 10 * cap + slot
            for group in ("pll_pilot", "pll_rds", "frame"):
                for f, v in it[key][group].items():
                    assert np.all(v == want), (key, group, f)
            assert it[key]["frame"]["carry"].shape == (27,)


def test_host_outputs_at_a_tuple_row():
    """``host_outputs`` at (capture, slot) of outputs batched over two
    axes: L, R and every leaf of the bit layer from that row."""
    base = 10 * np.arange(2)[:, None] + np.arange(3)[None, :]

    def leaf(width=None):
        return base if width is None else np.repeat(base[..., None], width,
                                                     -1)
    arrays = (leaf(8), -leaf(8), leaf(), leaf(5), leaf(5), leaf(),
              *(leaf(4) for _ in range(7)))
    out = drive.host_outputs(arrays, (1, 2))
    assert np.all(out["left"] == 12) and np.all(out["right"] == -12)
    assert out["frame"]["n_sym"] == 12 and out["frame"]["n_windows"] == 12
    for k in ("symbols", *check.FRAME_KEYS):
        assert np.all(out["frame"][k] == 12), k
