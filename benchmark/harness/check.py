"""The comparison that decides a run's ``correct``.

What a run compares (its items): for a few streams, drawn from the seed,
the first blocks from the receiver's initial state; and, at times drawn
from the seed across the measured window, one block ``s`` of one stream
each.  Per item the entry driver keeps what the timed path produced: L
and R audio (floats, or the int16 the stream runner emits) and the bit
layer's outputs.

The reference works each item out from the same raw bytes: the
configuration's reference front turns what a stream carries into the
station's I and Q at ``rf.fs``, and the golden receiver
(``benchmark/reference/golden.py``) decodes them from the RF low-pass on.
The front is ``benchmark/reference/front_<name>.py``, named by the
configuration file's ``reference_front`` ("u8", a station's own u8 I/Q,
where it names none).  It holds a class ``Front(config, precision)`` with
``init(lanes)`` and ``step(state, raws, where) -> (state, i, q)``:
``raws`` what ``block_of`` gives for each lane, ``where`` each lane's
``(stream, block)``, ``i`` and ``q`` (lanes, block_size // 2) float64.
Its memory is finite, under half a block, or closed-form in ``where`` (a
mixing phase that follows absolute time), so that a window item can
rebuild it as it rebuilds the filters.

A start item runs from the reference's own initial state.  A window item
cannot: the stream's state at block ``s`` is the sum of thousands of
blocks.  Its front's and filters' histories are finite, so the reference
rebuilds them from the raw bytes of blocks ``s - 2`` and ``s - 1``; the
two recurrences that never forget, the PLLs and the bit layer's sync
state, it takes from the program's state before block ``s - 1`` (the
PLLs, which then run a whole block in the reference) and before block
``s`` (the bit layer).  The start items check the stereo loop (through L
and R), the RDS chain and the bit layer's state across blocks without any
state of the program's.

Numbers compared, each with a limit from the workload file:

``mono_err`` the largest absolute difference of a sample of the mono
audio, ``(L + R) / 2``: the discriminator and the audio filter, which no
loop decides, so every sample is held to rounding.

``stereo_err`` per compared block, the median over its samples of the
absolute difference of ``(L - R) / 2``, the stereo channel that the pilot
loop's NCO demodulates; the largest over the compared blocks.  A median,
because the stereo is the one audio output that a recurrence carries:
where rounding sets the float32 program's pilot loop and the float64
reference's apart, the two settle together again within some hundred
samples, and one sample can part by up to 7.7e-3 (the two such blocks
seen: one run of the program, and the reference rounded to float32),
where wrong arithmetic or swapped channels move every sample.

``symbol_err`` per compared block, the median over its RDS symbols of each
symbol's difference from the reference's (``symbol_diffs``: up to the
carrier's sign, over the block's largest reference symbol); the largest
over the compared blocks (a differing symbol count is infinite).  Every
block of a window item is compared, and a start item's blocks from the
workload's ``pull_in_blocks`` on: from the initial state the RDS carrier
loop pulls in, and on the way it may slip a cycle where the float32
program and the float64 reference part by rounding.  A median, because at
a carrier-to-noise ratio near 15 dB the locked loop too slips now and
then on samples that rounding decides, and the few symbols around such a
slip part by percents, where wrong arithmetic moves every symbol.

``symbol_miss`` the number of symbols, over every compared block, further
than ``MISS_AT`` of the block's largest from the reference's.  What the
median cannot see: a block's head, the first symbols that the filters'
histories from the block before decide (a history never advanced, or
handed over wrong), and single symbols of the wrong sign (wrong bits).
Sound runs miss only around a slip; such a fault misses in every block.

``frame_mismatch`` the number of windows whose syndrome, sync,
false-positive, resync flag or position differ from what the reference's
bit layer gives on the program's own symbols (a differing window count
counts every window of the larger): integer logic on the same values, so
its limit is 0, where the symbols themselves are held to ``symbol_err``
and ``symbol_miss``.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import core
from benchmark.reference import golden

FRAME_KEYS = ("syndrome_id", "is_sync", "is_false_pos", "is_resync",
              "positions")
SIGN_SPAN = 8       # symbols on each side that decide a symbol's sign
MISS_AT = 1e-3      # a symbol further than this from the reference's
#                     (a share of the block's largest) is a miss


def sample_items(rng: np.random.Generator, n_streams: int, n_start: int,
                 n_window: int) -> tuple[list[int], list[tuple[float, int]]]:
    """Streams for the start items, and (fraction of the window, stream) for
    the window items: one stream in each of ``n_window`` equal parts of the
    streams (so both halves of a batch are always compared), at times
    spread over the window in a seeded order."""
    starts = sorted(rng.choice(n_streams, min(n_start, n_streams),
                               replace=False).tolist())
    edges = np.linspace(0, n_streams, n_window + 1)
    streams = [int(rng.integers(int(edges[k]), max(int(edges[k]) + 1,
                                                   int(edges[k + 1]))))
               for k in range(n_window)]
    fractions = (np.arange(n_window) + rng.uniform(0.1, 0.9, n_window)
                 ) / n_window
    order = rng.permutation(n_window)
    return starts, sorted((float(fractions[k]), streams[o])
                          for k, o in enumerate(order))


def state_rows(state, c) -> dict:
    """The two never-forgetting recurrences of the program's state
    (``ReceiverState``) at row ``c`` (an index, or a tuple of them over
    several batch axes; None: an unbatched state), as tensors still on the
    device: the stereo pilot loop, the RDS carrier loop and the bit
    layer."""
    def rows(tree, fields):
        return {f: (getattr(tree, f) if c is None else getattr(tree, f)[c]
                    ).clone() for f in fields}
    return {"pll_pilot": rows(state.audio.pll, golden.PLL_FIELDS),
            "pll_rds": rows(state.rds.pll, golden.PLL_FIELDS),
            "frame": rows(state.frame, golden.FRAME_FIELDS)}


def to_host(snap: dict) -> dict:
    return {k: {f: v.cpu().numpy() for f, v in d.items()}
            for k, d in snap.items()}


def frame_dict(fo, c=None) -> dict:
    """A ``FrameOutputs`` of host arrays (row ``c`` of a batch) as the
    arrays compared."""
    def get(name):
        v = np.asarray(getattr(fo, name))
        return (v[c] if c is not None else v).copy()
    return {"n_sym": int(get("n_sym")), "symbols": get("symbols_i"),
            "n_windows": int(get("n_windows")),
            **{k: get(k) for k in FRAME_KEYS}}


def _inject(ref_state: dict, snaps: list[dict], key: str, lanes) -> None:
    if key == "frame":
        for lane, snap in zip(lanes, snaps):
            f = snap["frame"]
            ref_state["frame"][lane] = {
                "offset": int(f["offset"]), "start_pos": int(f["start_pos"]),
                "lonely_bit": float(f["lonely_bit"]),
                "prebit": int(f["prebit"]),
                "first_block": bool(f["first_block"]),
                "carry": np.asarray(f["carry"], np.int64),
                "base_pos": int(f["base_pos"]),
                "last_position": int(f["last_position"]),
                "bad_count": int(f["bad_count"])}
        return
    ref_state[key] = {f: np.array([float(s[key][f]) for s in snaps])
                      for f in golden.PLL_FIELDS}


def load_front(config: dict, precision: str):
    """The configuration's reference front (module docstring)."""
    name = config.get("reference_front", "u8")
    return core.load_module("reference", "front_" + name).Front(config,
                                                                precision)


def reference(config: dict, precision: str, block_of, items: list[dict]
              ) -> list[list[dict]]:
    """The reference's outputs of every item: per item, a list of one dict
    per compared block (``left``, ``right``, ``frame``), with
    ``frame_on_program`` (``on_outputs``).  ``block_of(c, b)`` is what
    stream ``c`` carries at its block ``b``, as the configuration's front
    takes it."""
    rx = golden.Receiver(config, precision)
    front = load_front(config, precision)

    def through_front(fst, where):
        return front.step(fst, [block_of(c, b) for c, b in where], where)
    out: list = [None] * len(items)
    start = [k for k, it in enumerate(items) if it["kind"] == "start"]
    if start:
        n_blocks = len(items[start[0]]["blocks"])
        fst, st = front.init(len(start)), rx.init(len(start))
        per = [[] for _ in start]
        for b in range(n_blocks):
            fst, i_rf, q_rf = through_front(
                fst, [(items[k]["stream"], b) for k in start])
            st, o = rx.step(st, i_rf, q_rf)
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

        fst, st = front.init(len(window)), rx.init(len(window))

        def iq_at(back):
            nonlocal fst
            fst, i_rf, q_rf = through_front(
                fst, [(it["stream"], it["blocks"][0] - back) for it in its])
            return i_rf, q_rf
        st, _ = rx.step(st, *iq_at(2), run="histories")
        _inject(st, [it["snap_prev"] for it in its], "pll_pilot", lanes)
        _inject(st, [it["snap_prev"] for it in its], "pll_rds", lanes)
        st, _ = rx.step(st, *iq_at(1), run="audio_rds")
        _inject(st, [it["snap_at"] for it in its], "frame", lanes)
        st, o = rx.step(st, *iq_at(0))
        for lane, k in enumerate(window):
            out[k] = [{"left": o["left"][lane], "right": o["right"][lane],
                       "frame": o["frame"][lane]}]
    return on_outputs(items, out, rx.resync)


def on_outputs(items: list[dict], refs: list[list[dict]], resync: bool
               ) -> list[list[dict]]:
    """``refs`` with ``frame_on_program``: the reference's bit layer run on
    the symbols of each block of each item's ``outputs``, chained from the
    item's starting bit-layer state, which the item's own bit layer has to
    give exactly.  ``refs`` itself is left as it is."""
    new = []
    for item, ref in zip(items, refs):
        state = (golden.frame_init() if item["kind"] == "start"
                 else _frame_state(item["snap_at"]))
        blocks = []
        for prog, r in zip(item["outputs"], ref):
            f = prog["frame"]
            on, state = golden.frame_symbols(
                f["symbols"][:f["n_sym"]], state, resync, state["offset"])
            blocks.append({**r, "frame_on_program": on})
        new.append(blocks + [dict(r) for r in ref[len(blocks):]])
    return new


def _frame_state(snap: dict) -> dict:
    f = snap["frame"]
    return {"offset": int(f["offset"]), "start_pos": int(f["start_pos"]),
            "lonely_bit": float(f["lonely_bit"]), "prebit": int(f["prebit"]),
            "first_block": bool(f["first_block"]),
            "carry": np.asarray(f["carry"], np.int64),
            "base_pos": int(f["base_pos"]),
            "last_position": int(f["last_position"]),
            "bad_count": int(f["bad_count"])}


def _worst(d: np.ndarray) -> float:
    """The largest absolute value; a NaN counts as infinite."""
    return float(np.max(np.nan_to_num(np.abs(d), nan=np.inf), initial=0.0))


def _median(d: np.ndarray) -> float:
    """The median absolute value; a NaN counts as infinite."""
    a = np.nan_to_num(np.abs(d), nan=np.inf)
    return float(np.median(a)) if a.size else 0.0


def symbol_diffs(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each symbol's difference from the reference's, over the largest
    reference symbol of the block, up to the carrier's sign: at each symbol
    the sign that most of the ``2 * SIGN_SPAN + 1`` symbols around it fit
    better.  The carrier is recovered from the squared subcarrier, so its
    sign is known only up to pi, and it turns over at a cycle slip; one
    symbol of the wrong sign among its neighbours is a wrong bit, and
    differs by twice its size."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if not len(ref):
        return np.zeros(0)
    peak = float(np.max(np.abs(ref))) or 1.0
    plus, minus = np.abs(prog - ref), np.abs(prog + ref)
    vote = np.convolve(np.sign(plus - minus), np.ones(2 * SIGN_SPAN + 1),
                       "same")
    d = np.where(vote > 0, minus, plus) / peak
    return np.nan_to_num(d, nan=np.inf)


def compare(items: list[dict], refs: list[list[dict]], pull_in: int = 0,
            where: dict | None = None) -> dict:
    """The numbers compared, over every block of every item; the symbols
    of a start item's first ``pull_in`` blocks are not held.  ``where``,
    if given, gets each number's worst block (kind, stream, block)."""
    worst = {"mono_err": 0.0, "stereo_err": 0.0, "symbol_err": 0.0,
             "symbol_miss": 0.0, "frame_mismatch": 0.0}
    totals = {"symbol_miss": 0, "frame_mismatch": 0}

    def note(name, value, it, b):
        if value > worst[name] or (value == np.inf and name not in
                                   (where or {})):
            worst[name] = value
            if where is not None:
                where[name] = {"kind": it["kind"], "stream": it["stream"],
                               "block": b, "value": value}
    for it, ref in zip(items, refs):
        if len(it["outputs"]) < len(ref):       # an answer that never came
            for name in ("mono_err", "stereo_err", "symbol_err",
                         "symbol_miss"):
                note(name, np.inf, it, None)
            totals["frame_mismatch"] += 1
        for n_b, (prog, r, b) in enumerate(zip(it["outputs"], ref,
                                               it["blocks"])):
            d_left, d_right = (np.asarray(prog[ch], np.float64) - r[ch]
                               for ch in ("left", "right"))
            note("mono_err", _worst((d_left + d_right) / 2), it, b)
            note("stereo_err", _median((d_left - d_right) / 2), it, b)
            pf, rf = prog["frame"], r["frame"]
            if pf["n_sym"] != rf["n_sym"]:
                note("symbol_err", np.inf, it, b)
                note("symbol_miss", np.inf, it, b)
            elif it["kind"] == "window" or n_b >= pull_in:
                d = symbol_diffs(pf["symbols"][:pf["n_sym"]],
                                 rf["symbols"][:rf["n_sym"]])
                note("symbol_err", float(np.median(d)) if len(d) else 0.0,
                     it, b)
                miss = int(np.sum(d > MISS_AT))
                note("symbol_miss", float(miss), it, b)
                totals["symbol_miss"] += miss
            rf = r["frame_on_program"]
            nw = min(pf["n_windows"], rf["n_windows"])
            if pf["n_windows"] != rf["n_windows"]:
                bad = max(pf["n_windows"], rf["n_windows"])
            else:
                diff = np.zeros(nw, bool)
                for k in FRAME_KEYS:
                    diff |= (np.asarray(pf[k][:nw]).astype(np.int64)
                             != np.asarray(rf[k][:nw]).astype(np.int64))
                bad = int(diff.sum())
            note("frame_mismatch", float(bad), it, b)
            totals["frame_mismatch"] += bad
    return {"mono_err": worst["mono_err"],
            "stereo_err": worst["stereo_err"],
            "symbol_err": worst["symbol_err"],
            "symbol_miss": (np.inf if worst["symbol_miss"] == np.inf
                            else float(totals["symbol_miss"])),
            "frame_mismatch": float(totals["frame_mismatch"])}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return all(numbers[k] <= limits[k] for k in numbers), checks
