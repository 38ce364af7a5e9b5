"""Nothing the benchmark runs imports JAX, jaxlib or the JAX package, by
whole top-level names (``rtsdr_tpu_torch`` is not ``rtsdr_tpu``); the
reference imports nothing of the program or of ``tests/``."""

import ast
import os
import subprocess
import sys

from benchmark.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "rtsdr_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*subdirs):
    for sub in subdirs:
        root = os.path.join(core.BENCH_DIR, sub)
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def test_whole_name_rule():
    assert "rtsdr_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "rtsdr_tpu.cli".split(".")[0] in FORBIDDEN
    assert set(core.FORBIDDEN) == FORBIDDEN


def test_sources_import_no_jax():
    subs = ("harness", "drivers", "metrics", "traffic", "reference",
            "roofline")
    seen = set()
    for path in list(_sources(*subs)) + [
            os.path.join(core.BENCH_DIR, f) for f in ("run.py", "control.py")]:
        for mod in _imports(path):
            top = mod.split(".")[0]
            seen.add(top)
            assert top not in FORBIDDEN, (path, mod)
    assert "rtsdr_tpu_torch" in seen and "torch" in seen


def test_reference_imports_nothing_of_the_program():
    for path in list(_sources("reference")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("rtsdr_tpu_torch", "tests", "torch_oracles",
                               "oracles", "chip_smoke"), (path, mod)
            if top == "benchmark":
                assert mod.startswith(("benchmark.traffic.synth",
                                       "benchmark.reference")), mod
    for mod in _imports(os.path.join(core.BENCH_DIR, "traffic",
                                     "synth.py")):
        assert mod.split(".")[0] not in ("rtsdr_tpu_torch", "tests")


def test_loaded_modules_of_a_harness_process():
    """Every module a process loads by importing the harness, the drivers,
    the generator, the reference and the metrics."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import core, check, drive, trace\n"
        "from benchmark.reference import golden\n"
        "from benchmark.traffic import synth, feeder\n"
        "for kind, names in (('drivers', ('resident', 'stream')),"
        " ('metrics', [m['name'] for m in core.load_json(core.ROOT,"
        " 'BENCHMARK.json')['per_layer']])):\n"
        "    [core.load_module(kind, n) for n in names]\n"
        "import rtsdr_tpu_torch.io.stream\n"
        "print(' '.join(sorted(set(m.split('.')[0] for m in sys.modules))))\n"
        "print(core.forbidden_modules())\n") % core.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")
    tops = set(out[0].split())
    assert "rtsdr_tpu_torch" in tops and not tops & FORBIDDEN
    assert out[1] == "[]"
