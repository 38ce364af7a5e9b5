#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``rtsdr_tpu_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for (it exits 2, printing no result, without them).  Prints
information lines and, last, each compared number beside its limit on
standard error, and one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.  The harness is ``benchmark/harness``;
what a cell is made of is found by name under ``benchmark/``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or a library could write, at fixed paths inside
# the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:]))
