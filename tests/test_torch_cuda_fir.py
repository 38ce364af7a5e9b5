"""``rtsdr_tpu_torch.ops.cuda_fir`` on CPU tensors (the plain version of
the FIR-bank kernel) against the JAX XLA route and against the Pallas
kernel in interpret mode.

XLA route (float32): 2e-6 * max|ref|.  Interpret-mode Pallas kernel: it
truncates its windows to bf16 as the TPU's matrix unit does, so it is held
at the JAX tests' own bound ``_bf16_tol`` (tests/test_pallas_fir.py); the
port computes in float32.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops import fir as jfir
from rtsdr_tpu.ops import pallas_fir as jpf
from rtsdr_tpu_torch.ops import cuda_fir as tcf
from rtsdr_tpu_torch.ops import fir as tfir

torch.set_num_threads(1)

BANK_H = [coeffs.bandpass_taps(240e3, 18.5e3, 19.5e3, 151),
          coeffs.bandpass_taps(240e3, 22e3, 54e3, 151),
          coeffs.bandpass_taps(240e3, 54e3, 60e3, 151)]
AUDIO_H = coeffs.lowpass_taps(240e3, 16e3, 151)
# the interpret-mode Pallas kernel takes a decimating 151-tap bank only from
# 1024 channels up; its own tests decimate with 101 taps (test_pallas_fir.py)
AUDIO_H101 = coeffs.lowpass_taps(240e3, 16e3, 101)


def _bf16_tol(y):
    return 2e-2 * float(np.max(np.abs(y))) + 1e-6


def _f32_tol(y):
    return 2e-6 * float(np.max(np.abs(y)))


def _inputs(rng, c, n, t1=150):
    return (rng.standard_normal((c, n)).astype(np.float32),
            rng.standard_normal((c, n)).astype(np.float32),
            rng.standard_normal((c, t1)).astype(np.float32))


def _pre_np(x, x2, pre):
    return x * x if pre == "square" else 2.0 * x * x2 if pre == "mul2" else x


@pytest.mark.parametrize("pre", ["none", "square", "mul2"])
@pytest.mark.parametrize("stride", [1, 5])
@pytest.mark.parametrize("n_f", [1, 2, 3])
def test_carried_matches_xla_route(rng, pre, stride, n_f):
    x, x2, zi = _inputs(rng, 3, 1280)
    hs = BANK_H[:n_f] if stride == 1 else [AUDIO_H] * n_f
    ys, tail = tcf.fir_bank_carried(torch.as_tensor(x), hs,
                                    torch.as_tensor(zi), stride,
                                    x2=torch.as_tensor(x2), pre=pre)
    xp = jnp.asarray(_pre_np(x, x2, pre))
    assert len(ys) == n_f
    for y, h in zip(ys, hs):
        ref, ref_zi = jfir.fir_decimate(xp, h, jnp.asarray(zi), stride)
        ref = np.asarray(ref)
        assert y.numpy().shape == ref.shape and y.numpy().dtype == ref.dtype
        np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=_f32_tol(ref))
    np.testing.assert_allclose(tail.numpy(), np.asarray(ref_zi), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("pre,stride,n_f", [
    ("none", 1, 3), ("none", 1, 2), ("square", 1, 1), ("mul2", 1, 1),
    ("none", 5, 1), ("mul2", 5, 1)])
def test_carried_matches_pallas_interpret(rng, pre, stride, n_f):
    c, n = 32, 2560
    hs = BANK_H[:n_f] if stride == 1 else [AUDIO_H101]
    x, x2, zi = _inputs(rng, c, n, len(hs[0]) - 1)
    assert jpf.eligible(jnp.asarray(x), len(hs[0]), stride)
    p_ys, p_zi = jpf.fir_bank_carried(
        jnp.asarray(x), hs, jnp.asarray(zi), stride,
        x2=jnp.asarray(x2) if pre == "mul2" else None, pre=pre)
    t_ys, t_zi = tcf.fir_bank_carried(
        torch.as_tensor(x), hs, torch.as_tensor(zi), stride,
        x2=torch.as_tensor(x2) if pre == "mul2" else None, pre=pre)
    for t, p in zip(t_ys, p_ys):
        p = np.asarray(p)
        np.testing.assert_allclose(t.numpy(), p, rtol=0, atol=_bf16_tol(p))
    np.testing.assert_allclose(t_zi.numpy(), np.asarray(p_zi), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("pre", ["square", "mul2"])
def test_fir_block_pre_matches(rng, pre):
    x, x2, zi = _inputs(rng, 4, 1536)
    ty, tz = tcf.fir_block_pre(torch.as_tensor(x), BANK_H[2],
                               torch.as_tensor(zi), pre,
                               x2=torch.as_tensor(x2))
    jy, jz = jpf.fir_block_pre(jnp.asarray(x), BANK_H[2], jnp.asarray(zi),
                               pre, x2=jnp.asarray(x2))
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=_f32_tol(jy))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-6)


def test_fir_bank_zero_state(rng):
    x, _, _ = _inputs(rng, 2, 1000)
    ys = tcf.fir_bank(torch.as_tensor(x), BANK_H[:2])
    for y, h in zip(ys, BANK_H):
        ref, _ = jfir.fir_block(jnp.asarray(x), h,
                                jnp.zeros((2, 150), jnp.float32))
        ref = np.asarray(ref)
        np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=_f32_tol(ref))


def test_three_seams_equal_one_block(rng):
    """Four chained blocks (mixer fused, decimating) equal one long block:
    the carried tail is in the pre-op domain."""
    x, x2, _ = _inputs(rng, 2, 4 * 640)
    xt, x2t = torch.as_tensor(x), torch.as_tensor(x2)
    zi = torch.zeros(2, 150)
    outs = []
    for b in range(4):
        sl = slice(b * 640, (b + 1) * 640)
        (y,), zi = tcf.fir_bank_carried(xt[:, sl].contiguous(), [AUDIO_H], zi,
                                        5, x2=x2t[:, sl].contiguous(),
                                        pre="mul2")
        outs.append(y)
    (whole,), _ = tcf.fir_bank_carried(xt, [AUDIO_H], torch.zeros(2, 150), 5,
                                       x2=x2t, pre="mul2")
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), whole.numpy(),
                               rtol=0, atol=_f32_tol(whole.numpy()))


def test_ragged_shapes_and_leading_dims(rng):
    """Any C >= 1 and any N: no tile or lane alignment is required."""
    x = rng.standard_normal((1, 3, 1001)).astype(np.float32)
    zi = rng.standard_normal((1, 3, 150)).astype(np.float32)
    (y,), tail = tcf.fir_bank_carried(torch.as_tensor(x), [AUDIO_H],
                                      torch.as_tensor(zi), 5)
    assert tuple(y.shape) == (1, 3, 201) and tuple(tail.shape) == (1, 3, 150)
    xext = np.concatenate([zi, x], -1).astype(np.float64)
    ref = np.stack([np.convolve(r, AUDIO_H)[150:150 + 1001:5]
                    for r in xext.reshape(3, -1)]).reshape(1, 3, -1)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=_f32_tol(ref) * 2)
    assert np.array_equal(tail.numpy(), x[..., -150:])


# --------------------------------------------------------------------------
# CPU rehearsal of the kernel's plan (csrc/fir_bank.cu runs only on a card):
# tiles of threads x 4 x groups outputs, the span staged from 16-byte-aligned
# x index g0 = m0*s - lead into s polyphase planes with the pre-op and the zi
# look-back applied, the masked ragged edge, each output summed over the
# phase taps in the kernel's order (p = q*s + phi descending) with one fused
# multiply-add per tap, emulated in float64 and rounded to float32 once.

def _geometry(c, m, stride, n_f, taps, n_sm=132):
    """The (threads, groups) that rtsdr_fir_bank picks."""
    _, q_pad = tcf.bank_plan(taps, stride)
    cands = [(128, 2), (128, 1), (64, 1), (32, 1)][0 if stride == 1 else 1:]
    for th, g in cands:
        tile = th * 4 * g
        smem = 4 * (n_f * stride * q_pad + stride * (tile + q_pad))
        if c * -(-m // tile) >= 2 * n_sm and smem <= 200 * 1024:
            return th, g
    return 32, 1


def _bank_rehearsal(x, x2, zi, h_list, stride, pre, threads, groups):
    c, n = x.shape
    taps = len(h_list[0])
    t1 = taps - 1
    lead, q_pad = tcf.bank_plan(taps, stride)
    assert lead % 4 == 0 and q_pad % 4 == 0 and q_pad * stride >= lead + 1
    hp = tcf.phase_taps(h_list, stride).astype(np.float64)
    n_f, s = len(h_list), stride
    m_out = -(-n // s)
    tile = threads * 4 * groups
    plane = tile + q_pad
    n_tiles = -(-m_out // tile)
    xp = _pre_np(x, x2, pre).astype(np.float32)
    # o of thread t, group g, output r: consecutive 4 per thread, a
    # permutation of the tile
    t, g, r = np.meshgrid(np.arange(threads), np.arange(groups),
                          np.arange(4), indexing="ij")
    o = (g * 4 * threads + t * 4 + r).ravel()
    assert np.array_equal(np.sort(o), np.arange(tile))
    y = np.full((n_f, c, m_out), np.nan, np.float32)
    for tix in range(n_tiles):
        m0 = tix * tile
        g0 = m0 * s - lead
        assert g0 % 4 == 0
        gi = g0 + np.arange(plane * s)                      # span's x index
        span = np.where(gi[None] >= n, 0.0, xp[:, np.clip(gi, 0, n - 1)])
        back = (gi < 0) & (gi >= -t1)
        span = np.where(back[None], zi[:, np.clip(t1 + gi, 0, t1 - 1)]
                        if t1 else 0.0, span)
        span = np.where((gi < -t1)[None], 0.0, span).astype(np.float32)
        planes = np.zeros((c, s, plane), np.float32)
        j = np.arange(plane * s)
        planes[:, j % s, j // s] = span
        acc = np.zeros((n_f, c, tile), np.float32)
        for p in range(s * q_pad - 1, -1, -1):       # output o reads
            ph, q = p % s, p // s                      # planes[ph, o + q]
            assert q + tile - 1 < plane
            xs = planes[:, ph, q:q + tile].astype(np.float64)
            for f in range(n_f):
                acc[f] = (hp[f, ph, q] * xs + acc[f]).astype(np.float32)
        keep = m0 + np.arange(tile) < m_out
        y[:, :, m0 + np.arange(tile)[keep]] = acc[:, :, keep]
    xext = np.concatenate([zi, xp], -1)
    return y, xext[:, -t1:]


@pytest.mark.parametrize("c,n,stride,pre,n_f", [
    (1, 15360, 1, "none", 3), (1, 15360, 5, "mul2", 1),
    (3, 16000, 1, "square", 1), (3, 16000, 10, "none", 1),
    (3, 4999, 5, "mul2", 1), (1, 4999, 1, "none", 2),
    (1024, 251, 1, "none", 3), (1024, 257, 5, "mul2", 1),
    (1024, 263, 10, "square", 1)])
def test_kernel_plan_equals_plain(c, n, stride, pre, n_f):
    """What ``csrc/fir_bank.cu`` computes, rehearsed index for index in
    numpy (151 taps: not a multiple of 4, 5 or 10; N = 15,360, 16,000 and
    primes: ragged last tiles and unaligned rows), equals the plain version
    within the kernel's tolerance of 2e-6 max|ref|; the geometry is the one
    the kernel picks for the shape."""
    rng = np.random.default_rng(7 + c + n)
    x, x2, zi = _inputs(rng, c, n)
    hs = (BANK_H if stride == 1 else [AUDIO_H, BANK_H[1], BANK_H[2]])[:n_f]
    th, gr = _geometry(c, -(-n // stride), stride, n_f, 151)
    got, tail = _bank_rehearsal(x, x2, zi, hs, stride, pre, th, gr)
    ys, want_tail = tcf.fir_bank_carried_ref(
        torch.as_tensor(x), hs, torch.as_tensor(zi), stride,
        x2=torch.as_tensor(x2), pre=pre)
    for f, want in enumerate(ys):
        want = want.numpy()
        np.testing.assert_allclose(got[f], want, rtol=0, atol=_f32_tol(want))
    assert np.array_equal(tail, want_tail.numpy())


def test_kernel_geometry_fills_the_card():
    """Two blocks per SM wherever the work allows; wide tiles at C >= 1,024
    (the halo a small share of the span); the narrowest tile at C = 1."""
    assert _geometry(1024, 15360, 1, 3, 151) == (128, 2)
    assert _geometry(1024, 3072, 5, 1, 151) == (128, 1)
    assert _geometry(1, 15360, 1, 3, 151) == (32, 1)      # 120 blocks
    assert _geometry(128, 15360, 1, 3, 151) == (128, 2)   # wideband bank
    assert _geometry(32, 15360, 10, 1, 151) == (128, 1)   # scan, s = 10


def test_phase_taps_cached_by_identity():
    """The wrapper's taps come from a cache keyed by the arrays' identity:
    the same arrays give the same device tensor without a rebuild, a new
    list of the same arrays too."""
    a = tcf.derived_from_list([AUDIO_H], ("phase", 5, "cpu"),
                              lambda: tcf.phase_taps([AUDIO_H], 5))
    b = tcf.derived_from_list([AUDIO_H], ("phase", 5, "cpu"),
                              lambda: pytest.fail("rebuilt"))
    assert a is b
    t = tcf._taps_on(BANK_H, "cpu")
    assert t is tcf._taps_on(list(BANK_H), "cpu")
    np.testing.assert_array_equal(
        t.numpy(), np.stack(BANK_H).astype(np.float32))


def test_taps_cache_keeps_dropped_taps_until_its_next_emptying(monkeypatch):
    """A wrapper takes the pointers of several cached taps in one call
    (K1's bank entry: three), and a later lookup may empty the cache: the
    taps it drops stay alive, so their memory goes to no new tensor before
    the kernel that reads them is queued, and go at the next emptying."""
    cache = tfir.DeviceCache(limit=2)
    first = torch.arange(4.0)
    seen = weakref.ref(first)
    cache["a"] = (first,)
    cache["b"] = (torch.zeros(1),)
    cache["c"] = (torch.ones(1),)
    del first
    cache.make_room()                   # 3 entries > 2: emptied
    assert not cache and seen() is not None
    for k in "def":
        cache[k] = (torch.zeros(1),)
    cache.make_room()
    assert not cache and seen() is None
    # the taps cache itself: the first of many new arrays outlives the
    # emptying its followers cause
    monkeypatch.setattr(tfir, "_derived", tfir.DeviceCache())
    arrays = [np.full(3, float(k)) for k in range(80)]
    for a in arrays:
        tcf._taps_on([a], "cpu")
    assert len(tfir._derived) == 80 - 65
    assert any(v[0][0] is arrays[0] for v in tfir._derived.dropped)
