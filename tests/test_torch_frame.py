"""``rtsdr_tpu_torch.pipeline.frame`` (batched tensor ops, CPU) against
``rtsdr_tpu.pipeline.frame`` (per channel) on the same RRC arrays.

Integer and bool outputs and state leaves must be EQUAL; float leaves
within 1e-6 (float32 sums in two orders; cos/sin/atan2 of two libraries).
The RRC arrays are crafted symbol streams (as tests/test_frame_edges.py
makes them) and the oracle's synthesized RDS baseband, so both layers see
identical inputs whatever the DSP before them does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.pipeline import frame as jframe
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.pipeline import frame as tframe

from oracles import encode_rds_blocks, rds_baseband

torch.set_num_threads(1)

R = MODE0.rds_len
SPS = 24
INT_KINDS = "biu"


def _symbols_for_bits(bits, start_pad=0):
    prev, sym = 0, [1.0] * start_pad
    for b in bits:
        prev ^= int(b)
        s = 2.0 * prev - 1.0
        sym.extend([s, -s])
    sym = np.array(sym)
    return -sym if sym[0] < 0 else sym


def _crafted(seed, offset, n_blocks, start_pad=0, drift=0.0, rotate=0.0,
             noise=0.0, burst=False):
    """(n_blocks, 2, R) float32: symbols at rrc[offset + 24 k (1 + drift)],
    linearly interpolated onto the grid, rotated by ``rotate`` rad."""
    rng = np.random.default_rng(seed)
    bits = encode_rds_blocks(rng.integers(0, 2, (60, 16)))
    if burst:
        bits = bits.copy()
        bits[9 * 26 + 7:9 * 26 + 12] ^= np.array([1, 0, 1, 1, 1])
    sym = _symbols_for_bits(bits, start_pad)
    n = n_blocks * R
    pos = offset + SPS * (1.0 + drift) * np.arange(len(sym))
    keep = pos < n - 2
    total = np.zeros(n)
    lo = np.floor(pos[keep]).astype(int)
    frac = pos[keep] - lo
    np.add.at(total, lo, sym[keep] * (1 - frac))
    np.add.at(total, lo + 1, sym[keep] * frac)
    # a pulse a few samples wide, so the timing detectors have a slope
    total = np.convolve(total, np.hanning(15) / np.hanning(15).max(),
                        mode="same")
    total += 1e-6 * np.sin(np.arange(n)) + noise * rng.standard_normal(n)
    i = (total * np.cos(rotate)).astype(np.float32)
    q = (total * np.sin(rotate)).astype(np.float32)
    return np.stack([i, q], 0).reshape(2, n_blocks, R).transpose(1, 0, 2)


def _baseband(seed, n_blocks):
    """The oracle's RRC-shaped RDS baseband through a second (matched) RRC,
    as float32 blocks; Q is a scaled copy plus noise."""
    from rtsdr_tpu.ops.coeffs import rrc_taps

    rng = np.random.default_rng(seed)
    wave = rds_baseband(encode_rds_blocks(rng.integers(0, 2, (80, 16))))
    x = np.convolve(wave, rrc_taps(57e3, 151))[7:7 + n_blocks * R]
    q = 0.2 * x + 0.01 * rng.standard_normal(x.shape)
    return np.stack([x, q], 0).astype(np.float32).reshape(
        2, n_blocks, R).transpose(1, 0, 2)


def _assert_tree_equal(t_tree, j_tree, what):
    for name in t_tree._fields:
        t = getattr(t_tree, name).numpy()
        j = np.asarray(getattr(j_tree, name))
        assert t.shape == j.shape, (what, name, t.shape, j.shape)
        if j.dtype.kind in INT_KINDS:
            # the reference's integer sums widen under its 64-bit test
            # mode; the values are what must be equal
            assert t.dtype.kind in INT_KINDS, (what, name, t.dtype)
            assert np.array_equal(t, j), (what, name, t, j)
        else:
            assert t.dtype == j.dtype, (what, name)
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6,
                                       err_msg=f"{what} {name}")


def _run_both(blocks, batched=False, **kw):
    """blocks: (n_blocks, 2, R) or, batched, (n_blocks, C, 2, R)."""
    t_fn = tframe.make_frame(MODE0, **kw)
    j_fn = jframe.make_frame(JMODE0, **kw)
    batch = (blocks.shape[1],) if batched else ()
    t_state = tframe.frame_init(MODE0, batch, torch.float32, "cpu")
    j_states = [jframe.frame_init(JMODE0, jnp.float32)
                for _ in range(batch[0] if batched else 1)]
    syncs = 0
    for b, blk in enumerate(blocks):
        t_out, t_state = t_fn(t_state, torch.as_tensor(blk[..., 0, :].copy()),
                              torch.as_tensor(blk[..., 1, :].copy()))
        rows = blk if batched else blk[None]
        j_outs = []
        for c, row in enumerate(rows):
            j_out, j_states[c] = j_fn(j_states[c], jnp.asarray(row[0]),
                                      jnp.asarray(row[1]))
            j_outs.append(j_out)
        if batched:
            j_out = jax.tree.map(lambda *xs: np.stack(xs), *j_outs)
            j_state = jax.tree.map(lambda *xs: np.stack(xs), *j_states)
        else:
            j_out, j_state = j_outs[0], j_states[0]
        _assert_tree_equal(t_out, j_out, f"block {b} outputs")
        _assert_tree_equal(t_state, j_state, f"block {b} state")
        syncs += int(t_out.is_sync.sum())
    return syncs


def test_tables_equal():
    assert np.array_equal(tframe.H_MATRIX, jframe.H_MATRIX)
    assert np.array_equal(tframe.SYNDROMES, jframe.SYNDROMES)
    assert tframe.SYNDROME_NAMES == jframe.SYNDROME_NAMES
    assert tframe.CARRY_BITS == jframe.CARRY_BITS
    for a, b in zip(tframe._burst_table(), jframe._burst_table()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tframe.frame_sizes(MODE0) == jframe.frame_sizes(JMODE0)
    assert tframe.gardner_gain(MODE0) == jframe.gardner_gain(JMODE0)


@pytest.mark.parametrize("offset_mode", ["hold", "track", "argmax", "gardner"])
@pytest.mark.parametrize("offset,start_pad", [(0, 0), (5, 1), (12, 0),
                                              (23, 1)])
def test_offset_modes_match_jax(offset_mode, offset, start_pad):
    blocks = _crafted(offset * 7 + start_pad, offset, 5, start_pad)
    syncs = _run_both(blocks, offset_mode=offset_mode)
    if offset_mode != "track":      # track oscillates off-peak by design
        assert syncs >= 3


@pytest.mark.parametrize("kw", [
    dict(use_abs_clock=True),
    dict(resync=True),
    dict(resync=True, error_correct=True),
    dict(error_correct=True),
    dict(derotate=True),
    dict(derotate=True, offset_mode="gardner"),
    dict(with_cprime=False),
    dict(offset_mode="gardner", resync=True, error_correct=True,
         derotate=True, use_abs_clock=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_options_match_jax(kw):
    # a rotated, drifting, noisy stream with one 5-bit burst: every option
    # has something to do
    blocks = _crafted(0xF4, 7, 5, rotate=0.6 if kw.get("derotate") else 0.0,
                      drift=2e-4, noise=0.02, burst=True)
    _run_both(blocks, **kw)


@pytest.mark.parametrize("offset_mode", ["hold", "gardner"])
def test_synthesized_baseband_matches_jax(offset_mode):
    syncs = _run_both(_baseband(0x5757, 5), offset_mode=offset_mode,
                      use_abs_clock=True, resync=True)
    assert syncs >= 5


def test_resync_fires_and_matches_jax():
    """The decoy anchor of tests/test_frame_edges.py: >10 false positives
    reset the anchor; both walks fire at the same windows."""
    rng = np.random.default_rng(7)
    decoy = encode_rds_blocks([0x5A5A])[:26]
    bits = np.concatenate(
        [[0], decoy, [0, 1, 1, 0, 1],
         encode_rds_blocks(rng.integers(0, 2, (400, 16)))])
    sym = _symbols_for_bits(bits)
    n_blocks = 14
    total = np.zeros(n_blocks * R)
    idx = 6 + SPS * np.arange(len(sym))
    idx = idx[idx < len(total)]
    total[idx] = sym[:len(idx)]
    total += 1e-6 * np.sin(np.arange(len(total)))
    x = total.astype(np.float32).reshape(n_blocks, 1, R)
    blocks = np.concatenate([x, x], 1)
    t_fn = tframe.make_frame(MODE0, resync=True)
    state = tframe.frame_init(MODE0, (), torch.float32, "cpu")
    fired = 0
    for blk in blocks:
        out, state = t_fn(state, torch.as_tensor(blk[0]),
                          torch.as_tensor(blk[1]))
        fired += int(out.is_resync.sum())
    assert fired >= 1
    _run_both(blocks, resync=True)


@pytest.mark.parametrize("kw", [dict(), dict(resync=True, error_correct=True,
                                             offset_mode="gardner")],
                         ids=["default", "walk-ec-gardner"])
def test_batched_equals_per_channel(kw):
    """C = 3 different stations in one batched call == each alone (and ==
    the reference per channel)."""
    rows = [_crafted(11, 3, 4), _baseband(0x42, 4),
            _crafted(12, 17, 4, start_pad=1, burst=True)]
    blocks = np.stack(rows, 1)                          # (4, 3, 2, R)
    _run_both(blocks, batched=True, **kw)
    t_fn = tframe.make_frame(MODE0, **kw)
    st_b = tframe.frame_init(MODE0, (3,), torch.float32, "cpu")
    st_1 = [tframe.frame_init(MODE0, (), torch.float32, "cpu")
            for _ in range(3)]
    for blk in blocks:
        x = torch.as_tensor(blk)
        out_b, st_b = t_fn(st_b, x[:, 0], x[:, 1])
        for c in range(3):
            out_1, st_1[c] = t_fn(st_1[c], x[c, 0], x[c, 1])
            for name in out_b._fields:
                assert torch.equal(getattr(out_b, name)[c],
                                   getattr(out_1, name)), (c, name)
            for name in st_b._fields:
                assert torch.equal(getattr(st_b, name)[c],
                                   getattr(st_1[c], name)), (c, name)


def test_two_batch_dims():
    blocks = np.stack([_crafted(s, 4 + s, 2) for s in range(4)], 1)
    t_fn = tframe.make_frame(MODE0, resync=True)
    x = torch.as_tensor(blocks)                          # (2, 4, 2, R)
    st_a = tframe.frame_init(MODE0, (2, 2), torch.float32, "cpu")
    st_b = tframe.frame_init(MODE0, (4,), torch.float32, "cpu")
    for blk in x:
        out_a, st_a = t_fn(st_a, blk[:, 0].reshape(2, 2, R),
                           blk[:, 1].reshape(2, 2, R))
        out_b, st_b = t_fn(st_b, blk[:, 0], blk[:, 1])
        for name in out_a._fields:
            a, b = getattr(out_a, name), getattr(out_b, name)
            assert torch.equal(a.reshape(b.shape), b), name


def _walk(sid, w_valid, base, last, bad, resync, corr):
    """The sequential sync walk (src/fm_radio.cpp:649-713) in numpy."""
    n = len(sid)
    is_sync, is_fp, is_rs = (np.zeros(n, bool) for _ in range(3))
    for w_i in range(n):
        gp = base + w_i
        match = sid[w_i] > 0 and w_valid[w_i]
        ok = last < 0 or gp - last == 26
        real = (match and ok) or (
            corr[w_i] and w_valid[w_i] and last >= 0 and gp - last == 26)
        fp = match and not ok
        if real:
            last = gp
        is_sync[w_i], is_fp[w_i] = real, fp
        if resync:
            bad = 0 if real else (bad + 1 if fp else bad)
            if bad > 10:
                is_rs[w_i] = True
                last, bad = -1, 0
    return is_sync, is_fp, is_rs, last, bad


@settings(max_examples=120, deadline=None)
@given(data=st.data(), resync=st.booleans(), with_corr=st.booleans())
def test_resolve_sync_closed_form_walk_and_jax_agree(data, resync, with_corr):
    """Random match patterns and entry states: the port's closed form
    (resync off) and its walk (resync on) equal the sequential walk and the
    reference's resolve_sync, batched two at a time."""
    w_max = 77
    rows = []
    for _ in range(2):
        density = data.draw(st.sampled_from([0.02, 0.1, 0.5, 0.95]))
        seed = data.draw(st.integers(0, 2 ** 31))
        rng = np.random.default_rng(seed)
        sid = ((rng.random(w_max) < density)
               * rng.integers(1, 5, w_max)).astype(np.int32)
        corr = np.zeros(w_max, bool)
        if with_corr:
            corr = (rng.random(w_max) < 0.2) & (sid == 0)
        n_windows = data.draw(st.integers(1, w_max))
        base = data.draw(st.integers(0, 500))
        last = data.draw(st.sampled_from(
            [-1, base - 26 + int(rng.integers(0, 30)),
             base - int(rng.integers(27, 80))]))
        bad = data.draw(st.integers(0, 11))
        rows.append((sid, np.arange(w_max) < n_windows, base, last, bad,
                     corr))
    cols = list(zip(*rows))
    got = tframe.resolve_sync(
        torch.as_tensor(np.stack(cols[0])), torch.as_tensor(np.stack(cols[1])),
        torch.as_tensor(cols[2], dtype=torch.int32),
        torch.as_tensor(cols[3], dtype=torch.int32),
        torch.as_tensor(cols[4], dtype=torch.int32), resync=resync,
        corr=torch.as_tensor(np.stack(cols[5])) if with_corr else None)
    for c, (sid, valid, base, last, bad, corr) in enumerate(rows):
        ref = _walk(sid, valid, base, last, bad, resync, corr)
        jax_got = jframe.resolve_sync(
            jnp.asarray(sid), jnp.asarray(valid), jnp.asarray(base, jnp.int32),
            jnp.asarray(last, jnp.int32), jnp.asarray(bad, jnp.int32),
            resync=resync, corr=jnp.asarray(corr) if with_corr else None)
        for f, (r, g, jg) in enumerate(zip(ref, got, jax_got)):
            assert np.array_equal(g[c].numpy(), r), (f, c)
            assert np.array_equal(np.asarray(jg), r), (f, c)
