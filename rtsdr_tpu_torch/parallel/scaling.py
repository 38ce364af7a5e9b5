"""Scaling harness: throughput against the number of channel shards.

Counterpart of ``rtsdr_tpu/parallel/scaling.py``: a weak-scaling sweep of
the channel-sharded receiver (channels grow with devices) reporting
channel-blocks per second and the efficiency against the one-device rate.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtsdr_tpu_torch.config import ReceiverConfig
from rtsdr_tpu_torch.parallel.channels import make_channel_sharded_receiver
from rtsdr_tpu_torch.parallel.mesh import make_mesh


def measure_scaling(
    cfg: ReceiverConfig,
    channels_per_device: int = 8,
    device_counts: list[int] | None = None,
    k1: int = 3,
    k2: int = 9,
    devices=None,
    **kwargs,
) -> list[dict]:
    """One record per device count: ``devices``, ``channels``,
    ``channel_blocks_per_sec`` and ``efficiency`` against the first count's
    per-device rate.  ``devices``: the devices to take the first n of
    (default every visible CUDA device); ``kwargs`` go to the receiver.
    The rate is a slope: (time of k2 steps - time of k1 steps) / (k2 - k1),
    each the best of two runs, on the host clock after a synchronise.

    Every count runs the compiled step, what users run and what the JAX
    sweep times (``jax.jit``): one ``CompiledStep`` on one device, one part
    per device on two or more (``utils/jit.py::ComposedStep``), so each
    efficiency sets a compiled step against a compiled baseline.  The
    untimed warm-up runs of each count take the capture."""
    mesh_all = make_mesh(devices=devices)
    n = len(mesh_all.devices)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
    rng = np.random.default_rng(0)
    results = []
    base_rate = None
    for n_dev in device_counts:
        mesh = make_mesh(n_dev, 1, devices=mesh_all.devices)
        n_ch = channels_per_device * n_dev
        init_fn, step_fn, _ = make_channel_sharded_receiver(
            cfg, mesh, n_ch, torch.float32, **kwargs)
        raw = rng.integers(0, 256, (n_ch, cfg.block_size), dtype=np.uint8)

        def run(k):
            state = init_fn()
            t0 = time.perf_counter()
            for _ in range(k):
                state, _ = step_fn(state, raw)
            # a value on the host: every device has finished
            float(sum(float(st.frontend.prev_i.sum()) for st in state))
            return time.perf_counter() - t0

        run(k1), run(k2)

        def slope(a, b):
            return (min(run(b) for _ in range(2))
                    - min(run(a) for _ in range(2))) / (b - a)

        # on a loaded host a small-k slope can come out <= 0: retry with a
        # wider spread, then clamp and flag the record
        dt = slope(k1, k2)
        unreliable = False
        if dt <= 0:
            dt = slope(k1, 4 * k2 - 3 * k1)
        if dt <= 0:
            dt = 1e-9
            unreliable = True
        rate = n_ch / dt
        if base_rate is None and not unreliable:
            base_rate = rate / n_dev
        rec = {"devices": n_dev, "channels": n_ch,
               "channel_blocks_per_sec": rate,
               "efficiency": (rate / (base_rate * n_dev)
                              if base_rate is not None else None)}
        if unreliable:
            rec["unreliable"] = True
        results.append(rec)
    return results
