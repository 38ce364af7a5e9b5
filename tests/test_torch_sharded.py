"""The port's channel-parallel receivers, its multi-process helpers and its
scaling harness, on meshes that repeat the ``cpu`` device (CPU, plain
versions).

Each channel shard runs the batched receiver over its own rows with no
communication, and every plain version computes a row from that row alone,
so the sharded receivers' outputs and state are EQUAL to the unsharded
receivers' (tests/test_timeshard.py asserts the same of the JAX package).
The two-process test brings up ``torch.distributed`` over gloo on
localhost in two worker processes started from this file, as
tests/test_multihost.py does for the JAX package: each worker ingests its
own rows and checks one channel-sharded step against a serial run of them.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.parallel import multihost, scaling
from rtsdr_tpu_torch.parallel.channels import (
    make_channel_sharded_receiver,
    make_wideband_sharded_receiver,
)
from rtsdr_tpu_torch.parallel.mesh import CHANNEL_AXIS, TIME_AXIS, make_mesh
from rtsdr_tpu_torch.parallel.scaling import measure_scaling
from rtsdr_tpu_torch.pipeline.receiver import ReceiverOutputs, make_receiver
from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
from rtsdr_tpu_torch.utils.jit import CompiledStep
from rtsdr_tpu_torch.utils.shards import concat_rows, step_shards
from rtsdr_tpu_torch.utils.signals import fm_multiplex_iq, wideband_capture_iq

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_trees_equal(a, b, path="tree"):
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")


def test_make_mesh_shapes_and_devices():
    mesh = make_mesh(3, 4, devices=["cpu"] * 3)
    assert mesh.shape == {CHANNEL_AXIS: 3, TIME_AXIS: 4}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_mesh(devices=["cpu", "cpu"]).shape[CHANNEL_AXIS] == 2
    with pytest.raises(ValueError):
        make_mesh(3, 1, devices=["cpu"])
    with pytest.raises(ValueError):
        make_mesh(1, 0, devices=["cpu"])


def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()


def test_channel_sharded_equals_serial():
    n_channels, ch_shards = 4, 2
    raw = np.stack([fm_multiplex_iq(MODE0.iq_len, mono_hz=700.0 + 300 * k,
                                    pilot_phase=0.5 * k)
                    for k in range(n_channels)])
    mesh = make_mesh(ch_shards, 1, devices=["cpu"] * ch_shards)
    init, step, rows = make_channel_sharded_receiver(MODE0, mesh, n_channels)
    assert rows == (slice(0, 2), slice(2, 4))
    s_init, s_step = make_receiver(MODE0, (n_channels,), device="cpu")
    st, ser_st = init(), s_init()
    assert len(st) == ch_shards
    st, out = step(st, raw)
    ser_st, ref = s_step(ser_st, torch.as_tensor(raw))
    _assert_trees_equal(out, ref, "outputs")
    _assert_trees_equal(concat_rows(list(st), torch.device("cpu")), ser_st,
                        "state")


def test_step_shards_steps_each_shard_and_gathers_in_order():
    """Each shard steps on its own input, states stay per shard, outputs
    (NamedTuples, None leaves) are concatenated along ``dim``."""
    def step(k):
        def f(st, x):
            return st + k, ReceiverOutputs(left=x + k, right=x, mono=x[:, :1],
                                           rds=None)
        return f

    x = torch.arange(12.0).reshape(2, 6)
    taken = []

    def parts():
        for g in range(3):
            taken.append(g)
            yield x[:, 2 * g:2 * g + 2]

    states, out = step_shards([step(1), step(2), step(3)], (10, 20, 30),
                              parts(), torch.device("cpu"), dim=1)
    assert states == (11, 22, 33) and taken == [0, 1, 2]
    assert torch.equal(out.right, x) and out.rds is None
    assert torch.equal(out.left, x + torch.tensor([1.0, 1, 2, 2, 3, 3]))
    assert torch.equal(out.mono, x[:, ::2])
    one = step_shards([step(1)], (0,), [x], torch.device("cpu"))[1]
    assert torch.equal(one.left, x + 1)


class OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on a CUDA device (its own index)."""

    is_cuda = property(lambda self: True)
    device = property(lambda self: torch.device("cuda", self.card))


def test_step_shards_makes_each_cuda_shard_device_current(monkeypatch):
    """Each shard whose input lies on a GPU steps inside that GPU's device
    guard (its kernels launch on that GPU's stream); a CPU shard enters
    none."""
    current, entered = [None], []

    class Guard:
        def __init__(self, d):
            self.d, self.prev = torch.device(d), None

        def __enter__(self):
            self.prev, current[0] = current[0], self.d
            entered.append(self.d)

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch.cuda, "device", Guard)
    ran_on = []

    def step(st, x):
        ran_on.append(current[0])
        return st, x.as_subclass(torch.Tensor)

    parts = []
    for card in (0, 1, 2):
        p = torch.full((1, 2), float(card)).as_subclass(OnCard)
        p.card = card
        parts.append(p)
    _, out = step_shards([step] * 3, (0, 1, 2), parts, torch.device("cpu"))
    cards = [torch.device("cuda", k) for k in range(3)]
    assert ran_on == cards and entered == cards and current[0] is None
    assert torch.equal(out, torch.tensor([[0.0, 0], [1, 1], [2, 2]]))
    ran_on.clear()
    step_shards([step], (0,), [torch.zeros(1, 2)], torch.device("cpu"))
    assert ran_on == [None] and entered == cards


def test_channel_count_must_split():
    with pytest.raises(ValueError, match="not divisible"):
        make_channel_sharded_receiver(
            MODE0, make_mesh(2, 1, devices=["cpu", "cpu"]), 3)


@pytest.fixture(scope="module")
def capture():
    """Two blocks of a 4-slot capture, stations in slots 1 and 2."""
    return wideband_capture_iq(
        2 * MODE0.iq_len, 4, {1: {}, 2: dict(mono_hz=700.0, stereo_hz=1.7e3)}
    ).reshape(2, 4 * MODE0.block_size)


def test_wideband_sharded_equals_unsharded(capture):
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    init, step = make_wideband_sharded_receiver(MODE0, mesh, 4)
    u_init, u_step = make_wideband_receiver(MODE0, 4, device="cpu")
    st, ust = init(), u_init()
    assert isinstance(st.rx, tuple) and len(st.rx) == 2
    for blk in capture:
        raw = torch.as_tensor(blk)
        st, out = step(st, raw)
        ust, ref = u_step(ust, raw)
        assert out.left.shape == (4, MODE0.audio_len)
        _assert_trees_equal(out, ref, "outputs")
    _assert_trees_equal(concat_rows(list(st.rx), torch.device("cpu")),
                        ust.rx, "rx state")
    _assert_trees_equal(st.chan_zi, ust.chan_zi, "chan_zi")


def test_wideband_sharding_must_split_the_slots():
    with pytest.raises(ValueError, match="not divisible"):
        make_wideband_receiver(MODE0, 4, device="cpu",
                               channel_sharding=["cpu"] * 3)


def test_measure_scaling_on_repeated_cpu_mesh():
    recs = measure_scaling(MODE0, channels_per_device=1, device_counts=[1, 2],
                           k1=1, k2=2, devices=["cpu", "cpu"],
                           enable_rds=False, enable_stereo=False)
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["channels"] for r in recs] == [1, 2]
    assert recs[0]["efficiency"] == 1.0 or recs[0].get("unreliable")
    assert all(r["channel_blocks_per_sec"] > 0 for r in recs)


def test_measure_scaling_runs_one_kind_of_step(monkeypatch):
    """Every device count of the sweep runs the same (compiled) step: a
    baseline of one kind against counts of another would make each
    efficiency compare two different steps."""
    kinds = []

    def recording(*a, **kw):
        made = make_channel_sharded_receiver(*a, **kw)
        kinds.append(type(made[1]))
        return made

    monkeypatch.setattr(scaling, "make_channel_sharded_receiver", recording)
    measure_scaling(MODE0, channels_per_device=1, device_counts=[1, 2],
                    k1=1, k2=2, devices=["cpu", "cpu"],
                    enable_rds=False, enable_stereo=False)
    assert len(kinds) == 2 and len(set(kinds)) == 1
    assert issubclass(kinds[0], CompiledStep)


def test_single_process_helpers():
    """Without a process group: one host owns every row."""
    assert multihost.initialize() is None
    assert multihost.host_channel_slice(6) == slice(0, 6)
    mesh = make_mesh(1, 1, devices=["cpu"])
    local = np.zeros((6, 8), np.uint8)
    x = multihost.make_global_input(mesh, 6, 8, local)
    assert x.shape == (6, 8) and x.device.type == "cpu"
    with pytest.raises(ValueError, match="local blocks"):
        multihost.make_global_input(mesh, 6, 8, local[:3])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_step():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=_REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers timed out")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"OK process {i}" in out, f"worker {i} output:\n{out}"


def _worker(rank: int, world: int, port: str) -> int:
    """One host: join the group, ingest its own rows, step them on a
    two-shard mesh of its own, check against a serial run of its rows."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    n_channels = 4
    rng = np.random.default_rng(0xD07)
    full = rng.integers(0, 256, (n_channels, MODE0.block_size),
                        dtype=np.uint8)
    sl = multihost.host_channel_slice(n_channels)
    assert sl == slice(2 * rank, 2 * rank + 2), sl
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    local = multihost.make_global_input(mesh, n_channels, MODE0.block_size,
                                        full[sl])
    assert torch.equal(local, torch.as_tensor(full[sl]))
    kw = dict(enable_rds=False, enable_stereo=False)
    init, step, _ = make_channel_sharded_receiver(MODE0, mesh, 2, **kw)
    _, out = step(init(), local)
    s_init, s_step = make_receiver(MODE0, (2,), device="cpu", **kw)
    _, ref = s_step(s_init(), local)
    assert torch.equal(out.mono, ref.mono)
    # the group is live: every host's checksum reaches every host
    sums = torch.tensor([float(out.mono.double().sum())], dtype=torch.float64)
    gathered = [torch.zeros_like(sums) for _ in range(world)]
    dist.all_gather(gathered, sums)
    assert torch.equal(gathered[rank], sums)
    dist.destroy_process_group()
    print(f"OK process {rank}: rows {sl.start}..{sl.stop - 1} match serial",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
