#!/usr/bin/env python3
"""What the spread route of the port's time-sharded receiver hands between
its time shards in one step, derived from ``rtsdr_tpu_torch/config.py``.

    python3 tools/torch_comm_model.py [--mode {0,1,1rds}] [--channels 1024]
        [--time-shards 4] [--handoff {exact,stale,iterate}]
        [--ingest {fused,split}] [--blend]
        [--profile FILE | --step-ms MS --pll-ms MS] [--link-gbps GBPS]

The counterpart of ``tools/comm_model.py`` for the port.  It walks the
hand-overs that ``parallel/timeshard.py``'s spread route makes through
``utils/shards.py::move`` (its own copy of the inventory, from the
configuration's tap counts and block lengths) and prints one JSON object:
each item with its moves per step and bytes per move, the bytes per step
in all, the bytes that would cross between devices on a row of T distinct
GPUs (everything but the moves between the row's home, the caller's
stream on its first device, and shard 0, which lies there too), and, per
channel, what one interior boundary (shard t-1 to shard t) carries.

Items (per move, C channels): the raw u8 chunk of each shard; the ingest
kernel's raw u8 tail (``fused``, the default on a GPU) or the normalized
I/Q tail (``split``); the discriminator's last sample (I and Q); the IF
band-pass bank's one shared tail; the RDS squared band-pass's tail; the
mono and stereo low-pass tails (mode 1: one mono / stereo pair); K6's
zero-stuffed mixed tail (I and Q); the RRC's tail (I and Q); the PLL
state (7 leaves of the stacked loops): ``exact`` chains it shard to shard,
``stale`` seeds each shard from home, ``iterate`` adds one halo pass; the
new carried state of each stage back home from shard T-1; the gathers of
left, right, mono and the RRC stream; with ``--blend`` the pilot power
summed home and the gain sent back.

With a step time and its PLL share, from ``--profile FILE`` (the JSON that
``tools/torch_profile_step.py --out FILE`` writes on the card: its device
busy per step and its ``pll_kernel`` rows) or from ``--step-ms`` and
``--pll-ms``, and a link bandwidth that the user names (``--link-gbps``;
there is no default), it also predicts a step over T distinct GPUs:
(step - pll) / T + the PLL term (``exact``: pll; ``stale``: pll / T;
``iterate``: 2 pll / T) + the cross-device bytes over the link.  Without
them it prints the traffic alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS  # noqa: E402

F32 = 4             # bytes
PLL_LEAVES = 7      # ops/pll.py::PLLState

#: the items of ``tools/comm_model.py::timeshard_traffic`` (its
#: ``ppermute_bytes``, one interior boundary, per channel) that this
#: model hands over in another form, and how
DIFFERS_FROM_JAX = {
    "pilot_zi": "the port's IF bank hands one shared tail (if_bank_tail) "
                "for its pilot, channel and RDS extract band-passes",
    "chan_zi": "within if_bank_tail",
    "extract_zi": "within if_bank_tail",
    "resampler_tail": "K6's zero-stuffed mixed tail (resampler_mixed_tail) "
                      "carries I and Q",
    "rrc_zi": "the RRC's tail (rrc_tail) carries I and Q",
    "mono_tail": "mode 1: one hand-over of the mono / stereo pair "
                 "(mono_stereo_pair_tail)",
    "stereo_mixed_tail": "mode 1: within mono_stereo_pair_tail",
}


def spread_traffic(cfg, n_channels: int, t_shards: int,
                   handoff: str = "exact", ingest: str = "fused",
                   enable_rds: bool | None = None,
                   stereo_blend: bool = False) -> dict:
    """The spread route's hand-overs in one step of ``n_channels`` rows
    over ``t_shards`` shards (float32; see the module's docstring)."""
    if handoff not in ("exact", "stale", "iterate"):
        raise ValueError(f"unknown handoff {handoff!r}")
    if ingest not in ("fused", "split"):
        raise ValueError(f"unknown ingest {ingest!r}")
    c, n_t = n_channels, t_shards
    rds = cfg.rds if enable_rds is not False else None
    t1 = cfg.rf.taps - 1
    s_t1 = cfg.stereo.taps - 1
    a_t1 = cfg.mono.taps * cfg.mono.up - 1
    items = []

    def add(name, kind, moves, per_move, local=0):
        """``local``: of the ``moves``, those between home and shard 0."""
        items.append({"item": name, "kind": kind, "moves_per_step": moves,
                      "bytes_per_move": per_move,
                      "bytes_per_step": moves * per_move,
                      "home_shard0_moves": local})

    def halo(name, carried, tail, new_state_moves=1, new_state=None):
        """Shard 0 takes the carried value from home, shard t > 0 its left
        neighbour's tail; the block's new state goes home from T-1."""
        add(f"{name} (carried, home -> shard 0)", "carry_in", 1, carried, 1)
        add(name, "halo", n_t - 1, tail)
        items[-1]["boundary"] = name.removesuffix("_i").removesuffix("_q")
        if new_state_moves:
            add(f"{name} (new state, shard T-1 -> home)", "carry_out",
                new_state_moves, new_state or carried // new_state_moves)

    add("raw_u8 chunks (home -> shard t)", "input", n_t,
        c * cfg.block_size // n_t, 1)
    if ingest == "fused":
        halo("raw_u8_halo", c * 2 * t1 * F32, c * 2 * t1, 2)
    else:
        halo("rf_iq_tail", c * 2 * t1 * F32, c * 2 * t1 * F32)
    halo("demod_prev_i", c * F32, c * F32)
    halo("demod_prev_q", c * F32, c * F32)
    halo("if_bank_tail", c * s_t1 * F32, c * s_t1 * F32)
    if rds:
        halo("squared_zi", c * s_t1 * F32, c * s_t1 * F32)
    leaf = (2 if rds else 1) * c * F32
    if handoff == "exact":
        add("pll_state (home -> shard 0)", "carry_in", PLL_LEAVES, leaf,
            PLL_LEAVES)
        add("pll_handoff", "halo", PLL_LEAVES * (n_t - 1), leaf)
        items[-1]["boundary"] = "pll_handoff"
    else:
        add("pll_state (home -> shard 0)", "carry_in", PLL_LEAVES, leaf,
            PLL_LEAVES)
        add("pll_seed (home -> shard t > 0)", "seed",
            PLL_LEAVES * (n_t - 1), leaf)
        if handoff == "iterate":
            add("pll_state (second pass, home -> shard 0)", "carry_in",
                PLL_LEAVES, leaf, PLL_LEAVES)
            add("pll_handoff", "halo", PLL_LEAVES * (n_t - 1), leaf)
            items[-1]["boundary"] = "pll_handoff"
    add("pll_state (new state, shard T-1 -> home)", "carry_out", PLL_LEAVES,
        leaf)
    if cfg.mono.up == 1:
        halo("mono_tail", c * a_t1 * F32, c * a_t1 * F32)
        halo("stereo_mixed_tail", c * a_t1 * F32, c * a_t1 * F32)
    else:
        halo("mono_stereo_pair_tail", c * 2 * a_t1 * F32, c * 2 * a_t1 * F32)
    if stereo_blend:
        add("pilot power (psum, shard t -> home)", "gather", n_t, c * F32, 1)
        add("blend gain (home -> shard t)", "input", n_t, c * F32, 1)
    add("left, right, mono (all_gather, shard t -> home)", "gather",
        3 * n_t, c * (cfg.audio_len // n_t) * F32, 3)
    if rds:
        comb_t1 = (rds.taps - 1) * rds.up + rds.anti_img_taps - 1
        halo("resampler_mixed_tail", c * 2 * comb_t1 * F32,
             c * 2 * comb_t1 * F32)
        halo("rrc_tail", c * 2 * (rds.rrc_taps - 1) * F32,
             c * 2 * (rds.rrc_taps - 1) * F32)
        add("rrc (all_gather, shard t -> home)", "gather", n_t,
            c * 2 * (cfg.rds_len // n_t) * F32, 1)
    total = sum(i["bytes_per_step"] for i in items)
    local = sum(i["home_shard0_moves"] * i["bytes_per_move"] for i in items)
    # what one interior boundary carries per channel: the demodulator's
    # I and Q as one item, the PLL state's leaves together
    boundary: dict = {}
    for i in items:
        if "boundary" in i and n_t > 1:
            per = i["bytes_per_move"] * i["moves_per_step"] // (n_t - 1) // c
            boundary[i["boundary"]] = boundary.get(i["boundary"], 0) + per
    return {"channels": c, "time_shards": n_t, "handoff": handoff,
            "ingest": ingest, "items": items, "bytes_per_step": total,
            "moves_per_step": sum(i["moves_per_step"] for i in items),
            "cross_device_bytes_per_step": total - local,
            "per_boundary_bytes_per_channel": boundary}


def profile_times(path: str) -> tuple[float, float]:
    """(device busy ms per step, PLL kernel ms per step) from a JSON line
    written by ``tools/torch_profile_step.py --out``."""
    with open(path) as f:
        prof = json.load(f)
    if "device_busy_ms_per_step" not in prof:
        raise ValueError(f"{path}: no device time in the profile")
    pll = sum(k["ms_per_step"] for name, k in prof["by_kernel"].items()
              if "pll_kernel" in name)
    return prof["device_busy_ms_per_step"], pll


def predict(traffic: dict, step_ms: float, pll_ms: float,
            link_gbps: float) -> dict:
    """A step over T distinct GPUs from a one-device step's time and its
    PLL share, the cross-device bytes at ``link_gbps``."""
    n_t = traffic["time_shards"]
    comm_ms = traffic["cross_device_bytes_per_step"] / (link_gbps * 1e9) * 1e3
    pll_term = {"exact": pll_ms, "stale": pll_ms / n_t,
                "iterate": 2 * pll_ms / n_t}[traffic["handoff"]]
    pred = (step_ms - pll_ms) / n_t + pll_term + comm_ms
    return {"step_ms_one_device": step_ms, "pll_ms_one_device": pll_ms,
            "link_gbytes_per_sec": link_gbps, "comm_ms": comm_ms,
            "predicted_step_ms": pred, "speedup": step_ms / pred}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=("0", "1", "1rds"), default="0")
    p.add_argument("--channels", type=int, default=1024)
    p.add_argument("--time-shards", type=int, default=4)
    p.add_argument("--handoff", choices=("exact", "stale", "iterate"),
                   default="exact")
    p.add_argument("--ingest", choices=("fused", "split"), default="fused")
    p.add_argument("--blend", action="store_true")
    p.add_argument("--profile", default=None, metavar="FILE",
                   help="step and PLL times from tools/torch_profile_step.py"
                        " --out FILE (a one-device step at --channels)")
    p.add_argument("--step-ms", type=float, default=None)
    p.add_argument("--pll-ms", type=float, default=None)
    p.add_argument("--link-gbps", type=float, default=None,
                   help="the link's GB/s between two GPUs of the row")
    args = p.parse_args(argv)
    cfg = {"0": MODE0, "1": MODE1, "1rds": MODE1_RDS}[args.mode]
    out = spread_traffic(cfg, args.channels, args.time_shards, args.handoff,
                         args.ingest, stereo_blend=args.blend)
    out["mode"] = args.mode
    times = None
    if args.profile:
        times = profile_times(args.profile)
    elif args.step_ms is not None and args.pll_ms is not None:
        times = (args.step_ms, args.pll_ms)
    if times and args.link_gbps:
        out["prediction"] = predict(out, *times, args.link_gbps)
    else:
        out["prediction"] = ("none: give a step time and its PLL share "
                             "(--profile, or --step-ms and --pll-ms) and "
                             "--link-gbps")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
