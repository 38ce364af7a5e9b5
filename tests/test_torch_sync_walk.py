"""The frame layer's resync walk: the CPU route of the port's
``resolve_sync(resync=True)`` (``pipeline/frame.py::_walk_plain``, the
plain version of the walk kernel ``csrc/sync_walk.cu``) against the JAX
package's ``resolve_sync(resync=True)`` (its ``lax.scan``), run un-jitted;
and where an on-card call goes (the kernel, once, or a raise).

Every output is an integer or a flag, so the two must be EQUAL.  The inputs
(``utils/signals.py::sync_walk_inputs``, one numpy seed) reach every branch
of the walk; each test checks that they did.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from rtsdr_tpu.pipeline import frame as jframe
from rtsdr_tpu_torch.ops import _cuda, cuda_sync
from rtsdr_tpu_torch.pipeline import frame as tframe
from rtsdr_tpu_torch.utils.signals import sync_walk_inputs

torch.set_num_threads(1)

W = 77                      # frame_sizes(MODE0)[3] and MODE1_RDS's
KEYS = ("sid", "w_valid", "base_pos", "last_position", "bad_count")


def _jax_walk(d):
    """The JAX walk, un-jitted, mapped over the leading dims."""
    fn = functools.partial(jframe.resolve_sync, resync=True)
    batch = d["sid"].shape[:-1]
    flat = {k: v.reshape(-1, *v.shape[len(batch):]) for k, v in d.items()}
    out = jax.vmap(lambda s, v, b, l, n, c: fn(s, v, b, l, n, corr=c))(
        *(jnp.asarray(flat[k]) for k in KEYS), jnp.asarray(flat["corr"]))
    return [np.asarray(o).reshape(*batch, *o.shape[1:]) for o in out]


def _torch_walk(d):
    return tframe.resolve_sync(*(torch.as_tensor(d[k]) for k in KEYS),
                               resync=True, corr=torch.as_tensor(d["corr"]))


def _assert_equal(got, ref, label=""):
    names = ("is_sync", "is_false_pos", "is_resync", "new_last", "new_bad")
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, (label, name)
        assert np.array_equal(g.numpy(), r), (label, name)


def _branches(d, got):
    """Which branches of the walk the inputs reached."""
    sync, fp, fire = (g.numpy() for g in got[:3])
    return {"anchor from unsynced": bool((sync & (d["last_position"] < 0)
                                          [..., None]).any()),
            "on-lattice sync": bool(sync.any()),
            "repair accepted": bool((sync & d["corr"]).any()),
            "repair refused": bool((~sync & d["corr"] & d["w_valid"]).any()),
            "false positive": bool(fp.any()),
            "resync": bool(fire.any()),
            "cut tail": bool((~d["w_valid"]).any())}


def test_walk_equals_jax_at_w77_over_64_lanes():
    d = sync_walk_inputs(np.random.default_rng(11), 64, W)
    got = _torch_walk(d)
    _assert_equal(got, _jax_walk(d))
    reached = _branches(d, got)
    assert all(reached.values()), reached


def test_walk_equals_jax_in_the_wideband_layout():
    """(captures, K, W) = (8, 16, 77): the wideband step's call."""
    d = sync_walk_inputs(np.random.default_rng(12), 128, W)
    d = {k: v.reshape(8, 16, *v.shape[1:]) for k, v in d.items()}
    got = _torch_walk(d)
    assert got[0].shape == (8, 16, W) and got[3].shape == (8, 16)
    _assert_equal(got, _jax_walk(d))
    assert all(_branches(d, got).values())


def test_walk_equals_jax_over_six_chained_blocks():
    """last_position / bad_count carried, base_pos advanced as the frame
    advances it (by the block's valid windows less one)."""
    rng = np.random.default_rng(13)
    d = sync_walk_inputs(rng, 32, W)
    fired = synced_late = 0
    for b in range(6):
        got, ref = _torch_walk(d), _jax_walk(d)
        _assert_equal(got, ref, f"block {b}")
        fired += int(got[2].sum())
        if b >= 3:
            synced_late += int(got[0].sum())
        n_windows = d["w_valid"].sum(-1)
        d = sync_walk_inputs(
            rng, 32, W, base_pos=d["base_pos"] + n_windows - 1,
            last_position=got[3].numpy(), bad_count=got[4].numpy())
    assert fired and synced_late


def test_cpu_tensors_take_the_plain_walk(monkeypatch):
    seen = []
    monkeypatch.setattr(_cuda, "launch", lambda *a: seen.append(a))
    plain = tframe._walk_plain
    calls = []
    monkeypatch.setattr(tframe, "_walk_plain",
                        lambda *a: calls.append(1) or plain(*a))
    d = sync_walk_inputs(np.random.default_rng(14), 4, W)
    _torch_walk(d)
    assert calls == [1] and seen == []


# ------------------------------------------------------------ on the card
class OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on a CUDA device."""

    is_cuda = property(lambda self: True)


def _on_card(d, **dtypes):
    return {k: torch.as_tensor(v).to(dtypes.get(k, torch.as_tensor(v).dtype))
            .as_subclass(OnCard) for k, v in d.items()}


class _Ops(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def launches(monkeypatch):
    seen = []
    monkeypatch.setattr(
        _cuda, "launch",
        lambda entry, count_as, *a: seen.append((entry, count_as, a[-2:])))
    return seen


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_on_card_call_launches_the_kernel_once(launches, monkeypatch, batch):
    lanes = int(np.prod(batch))
    d = sync_walk_inputs(np.random.default_rng(15), lanes, W)
    d = {k: v.reshape(batch + v.shape[1:]) for k, v in d.items()}
    t = _on_card(d)
    monkeypatch.setattr(tframe, "_walk_plain", None)    # must not be reached
    with _Ops() as ops:
        out = tframe.resolve_sync(*(t[k] for k in KEYS), resync=True,
                                  corr=t["corr"])
    assert launches == [("rtsdr_sync_walk", "sync_walk", (lanes, W))]
    # none of the plain walk's per-window ops
    assert not {"where", "stack", "__getitem__"} & set(ops.names), ops.names
    assert [tuple(o.shape) for o in out] == [(*batch, W)] * 3 + [batch] * 2
    assert [o.dtype for o in out] == [torch.bool] * 3 + [torch.int32] * 2


def test_on_card_call_without_repairs_passes_null(monkeypatch):
    d = _on_card(sync_walk_inputs(np.random.default_rng(16), 3, W))
    got = {}
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, count_as, *a: got.update(corr=a[2]))
    tframe.resolve_sync(*(d[k] for k in KEYS), resync=True)
    assert got == {"corr": None}


@pytest.mark.parametrize("key,dtype", [
    ("sid", torch.int64), ("sid", torch.float32),
    ("last_position", torch.int64), ("bad_count", torch.float32),
    ("base_pos", torch.int64), ("w_valid", torch.uint8),
    ("corr", torch.int32)])
def test_on_card_other_dtypes_raise(launches, key, dtype):
    d = _on_card(sync_walk_inputs(np.random.default_rng(17), 4, W),
                 **{key: dtype})
    with pytest.raises(TypeError):
        tframe.resolve_sync(*(d[k] for k in KEYS), resync=True,
                            corr=d["corr"])
    assert launches == []


def test_on_card_empty_block_raises(launches):
    d = _on_card(sync_walk_inputs(np.random.default_rng(18), 2, W))
    with pytest.raises(ValueError):
        cuda_sync.sync_walk(d["sid"][:, :0], d["w_valid"][:, :0],
                            d["base_pos"], d["last_position"],
                            d["bad_count"])
    assert launches == []


def test_on_card_too_many_windows_raises(launches):
    """The kernel stages a tile of rows in 48 KB of shared memory."""
    w = cuda_sync.MAX_WINDOWS
    for w_max, ok in ((w, True), (w + 1, False)):
        d = _on_card(sync_walk_inputs(np.random.default_rng(19), 2, w_max))
        call = functools.partial(tframe.resolve_sync, *(d[k] for k in KEYS),
                                 resync=True, corr=d["corr"])
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="windows"):
                call()
    assert launches == [("rtsdr_sync_walk", "sync_walk", (2, w))]
