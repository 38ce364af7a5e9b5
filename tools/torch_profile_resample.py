#!/usr/bin/env python3
"""A/B probe of the mixer + resampler kernel (K6, ``csrc/resample_rrc.cu``).

    python3 tools/torch_profile_resample.py [--channels 1024] [--reps 20]
        [--burst 10]

The port's counterpart of ``tools/profile_resample.py``, which asked two
layout questions of the TPU kernel: does refetching the taps every grid
step cost time, and does computing both branches against one filter read
pay.  On this card the taps sit in shared memory once per block, and the
second question is asked by K6's two arms:

  pair    a thread makes 4 outputs of one phase for both branches: one tap
          read per 8 multiply-adds (``impl="pair"``);
  split   a thread makes 8 outputs of one phase for one branch: one tap
          read per 8 multiply-adds, other rows of the window
          (``impl="split"``);
  plain   the plain PyTorch version (materialized mixer + ``fir_resample``;
          the segmented form's behind the halo zi made in stock ops).

Each runs on C rows of a full MODE0 block (15,360 samples, ↑19/↓80, the
3,001-tap composed filter) and on the T = 4 time-sharded receiver's stacked
chunks in the segmented form (4 x C rows of 3,840; MODE1_RDS: 4 x C rows
of 4,000 at ↑57/↓250 with 9,003 taps), with a non-zero carried ``zi``; each
is checked against the plain version and timed with CUDA events in turns
(plain, split, pair, pair, split, plain ...), median over ``--reps``.  Each
timing spans ``--burst`` back-to-back calls and is divided by their number,
so that the queue runs ahead of the host and the wrapper's host work drops
out of the kernel's time (a single call timed alone carries it).
Prints one JSON line per (variant, shape) with the card's name and power
limit.  Needs a CUDA device.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu_torch.config import MODE0, MODE1_RDS  # noqa: E402
from rtsdr_tpu_torch.ops import cuda_resample  # noqa: E402
from rtsdr_tpu_torch.pipeline.rds import composed_resampler_taps  # noqa: E402

H100_MEM_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--burst", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for cfg, t_sh, n in ((MODE0, None, MODE0.if_len),
                         (MODE0, 4, MODE0.if_len // 4),
                         (MODE1_RDS, 4, MODE1_RDS.if_len // 4)):
        h = composed_resampler_taps(cfg)
        up, down = cfg.rds.up, cfg.rds.down
        plain = (cuda_resample.resample_mul2_ref if t_sh is None else
                 cuda_resample.resample_mul2_segments_ref)
        variants = {
            "plain": lambda a: plain(*a),
            "split": lambda a: cuda_resample.resample_mul2(
                *a, impl="split", segments=t_sh),
            "pair": lambda a: cuda_resample.resample_mul2(
                *a, impl="pair", segments=t_sh),
        }
        lead = (args.channels,) if t_sh is None else (t_sh, args.channels)
        rows = math.prod(lead)
        e, ni, nq = (torch.randn(*lead, n, generator=gen, device=dev)
                     for _ in range(3))
        zi = cuda_resample.resample_mul2_tail(
            *(torch.randn(args.channels, n, generator=gen, device=dev)
              for _ in range(3)), len(h) - 1, up)
        a = (e, ni, nq, h, zi, up, down)
        ref = variants["plain"](a)[0]
        scale = float(ref.abs().max())
        times = {name: [] for name in variants}
        order = list(variants) + list(variants)[::-1]
        for name in order:                       # warm-up, in turns
            variants[name](a)
        for _ in range(args.reps):
            for name in order:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.burst):
                    variants[name](a)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / args.burst)
        m = n * up // down
        n_bytes = 4 * (3 * rows * n + 2 * zi.numel() + rows * 2 * m)
        flop = rows * 2 * m * 2 * -(-len(h) // up) + rows * 2 * n * 2
        bound = max(n_bytes / H100_MEM_BYTES_PER_S,
                    flop / H100_F32_FLOP_PER_S) * 1e3
        for name, fn in variants.items():
            y = fn(a)[0]
            print(json.dumps({
                "variant": name, "shape": f"3 x f32 {(*lead, n)}",
                "segments": t_sh,
                "up": up, "down": down, "taps": len(h),
                "ms": statistics.median(times[name]), "burst": args.burst,
                "ms_all": times[name],
                "rel_err_vs_plain": float((y - ref).abs().max()) / scale,
                "bound_ms": bound, "card": card}), flush=True)
        del e, ni, nq, zi, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
