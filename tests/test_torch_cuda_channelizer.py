"""CPU rehearsal of the composed-channelizer kernel's plan
(``csrc/channelizer.cu``, K5) and unit tests of ``composed_plan``.

The kernel runs only on a card, so what it computes is re-derived here in
numpy, index for index, and held against the plain version
(``composed_channelize_u8_ref``) at the tolerance ``chip_smoke.py`` holds
the kernel to on the card: 8e-6 * max over stations of sum|g| (two float32
sums of 2L products of |x| < 1 values in different orders), the new byte
tail equal.

The plan (``ops/channelizer.py``): the host sorts the stations into those
whose de-rotated taps are one real prototype (the shared route: real FIRs
over the d = decim*K polyphase planes, summed by residue, then a K-point DFT
per output) and the others (their own complex taps over the same planes).
One launch: blocks (capture, tile) x (own-taps groups, then the shared
role).  A block stages its tile's window of ext = [zi | raw] as polyphase
planes (plane b, row j = ext[e0 + j*d + d-1-b], zero level outside), ``nb``
planes per pass; a thread owns R = 8 outputs of one lane and one slice of
the planes, walks its planes (b = slice mod ns) in sub-steps of ``g``
planes, taps a ascending per output; the partial sums by slice then meet:
the shared role's DFT rows sum the slices s ascending with twiddle
W^{(k s) mod K}, the own role's slices add in order.

Fused multiply-adds are emulated in float64 (the product of two float32
values is exact there) and rounded to float32 once per step.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import channelizer as tch
from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps

torch.set_num_threads(1)

R = tch.K5_R
TOL_K5_REL = 8e-6            # chip_smoke.py's, x max over stations of sum|g|


def _fma(a, b, acc):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + acc).astype(np.float32)


def _mac(acc, t, x):
    """acc (re, im) += t * x, as the kernel's ``mac``: t real or complex."""
    re, im = acc
    if np.iscomplexobj(t):
        tr = np.float32(t.real) if np.ndim(t) == 0 else t.real
        ti = np.float32(t.imag) if np.ndim(t) == 0 else t.imag
        re = _fma(tr, x[0], re)
        re = _fma(-ti, x[1], re)
        im = _fma(tr, x[1], im)
        im = _fma(ti, x[0], im)
        return re, im
    return _fma(t, x[0], re), _fma(t, x[1], im)


def rehearse(raw, zi, g, decim, n_sm=132):
    """What the kernel writes for (B, 2n) bytes: (y (B, K, 2, P), tail)."""
    plan = tch.composed_plan(g, decim)
    n_cap = raw.shape[0]
    k, taps = g.shape
    d, a_sp, t1 = plan.d, plan.a_sp, taps - 1
    n = raw.shape[1] // 2
    p_out = n // d
    geo = tch.composed_geometry(plan, n_cap, p_out, n_sm)
    tile = geo.tile
    ext = np.concatenate([zi, raw], axis=1).astype(np.int64) - 128
    ext_c = np.stack([ext[:, 0::2], ext[:, 1::2]]).astype(np.float32)
    y = np.full((n_cap, k, 2, p_out), np.nan, np.float32)
    own_taps = None
    if plan.own:
        own_taps = (plan.own_taps[..., 0].astype(np.complex64)
                    + 1j * plan.own_taps[..., 1].astype(np.float32))
    tw = plan.twiddle
    for role in range(geo.roles):
        shared = role == geo.n_og
        lanes = 1 if shared else geo.own_lanes
        ns = geo.ns_sh if shared else geo.ns_own
        gsub = geo.g_sh if shared else geo.g_own
        assert lanes * ns * (tile // R) <= tch.K5_THREADS
        for tile_idx in range(geo.n_tiles):
            p0 = tile_idx * tile
            rows = tile + a_sp - 1
            assert rows <= geo.pitch and geo.pitch % 2 == 1
            e0 = d * (p0 - a_sp + 1) + taps - d
            # plane b, row j: ext[e0 + j*d + d-1-b]; zero level outside
            e = e0 + np.arange(rows)[None, :] * d + (d - 1
                                                      - np.arange(d)[:, None])
            inside = (e >= 0) & (e < t1 + n)
            planes = np.where(inside[None, None], ext_c[:, :, np.clip(
                e, 0, t1 + n - 1)], np.float32(0))      # (2, B, d, rows)
            # each thread's planes: passes of nb, sub-steps of gsub, b =
            # slice mod ns
            acc = np.zeros((2, n_cap, lanes, ns, tile), np.float32)
            seen = np.zeros((ns, d), int)
            for b0 in range(0, d, geo.nb):
                nbp = min(geo.nb, d - b0)
                for bs in range(b0, b0 + nbp, gsub):
                    ge = min(bs + gsub, b0 + nbp)
                    for s in range(ns):
                        for b in range(bs + (s - bs) % ns, ge, ns):
                            seen[s, b] += 1
                            for ln in range(lanes):
                                if shared:
                                    tap = plan.proto[b, :a_sp]
                                else:
                                    oi = role * geo.own_lanes + ln
                                    tap = (own_taps[b, :, oi]
                                           if oi < len(plan.own)
                                           else np.zeros(a_sp, np.complex64))
                                cur = (acc[0, :, ln, s], acc[1, :, ln, s])
                                for a in range(a_sp):
                                    # output i meets row i - a + a_sp - 1
                                    x = planes[:, :, b, a_sp - 1 - a:
                                               a_sp - 1 - a + tile]
                                    cur = _mac(cur, tap[a], x)
                                acc[0, :, ln, s], acc[1, :, ln, s] = cur
            assert (seen.sum(0) == 1).all()       # every plane once
            q = np.arange(tile)
            valid = p0 + q < p_out
            if shared:
                for kk in plan.shared:
                    s_re = np.zeros((n_cap, tile), np.float32)
                    s_im = np.zeros((n_cap, tile), np.float32)
                    for s in range(ns):
                        w = tw[(kk * s) % k]
                        s_re, s_im = _mac((s_re, s_im),
                                          np.complex64(w[0] + 1j * w[1]),
                                          acc[:, :, 0, s])
                    y[:, kk, 0, (p0 + q)[valid]] = s_re[:, valid]
                    y[:, kk, 1, (p0 + q)[valid]] = s_im[:, valid]
            else:
                for ln in range(lanes):
                    oi = role * geo.own_lanes + ln
                    if oi >= len(plan.own):
                        continue
                    s_re = np.zeros((n_cap, tile), np.float32)
                    s_im = np.zeros((n_cap, tile), np.float32)
                    for s in range(ns):
                        s_re = s_re + acc[0, :, ln, s]
                        s_im = s_im + acc[1, :, ln, s]
                    kk = plan.own[oi]
                    y[:, kk, 0, (p0 + q)[valid]] = s_re[:, valid]
                    y[:, kk, 1, (p0 + q)[valid]] = s_im[:, valid]
    tail = np.concatenate([zi, raw], axis=1)[:, 2 * n:]
    return y, tail


def _taps(k, decim, kind, taps_rf=151, tpb=16):
    h = tch.channelizer_taps(k, tpb)
    h_rf = rf_lpf_taps(MODE0) if taps_rf == 151 else np.hanning(taps_rf) / 3
    offs = None
    if kind == "one":
        offs = np.zeros(k)
        offs[k // 2] = 150e3
    elif kind == "all":
        offs = np.linspace(-90e3, 90e3, k) + 1e3
    return tch.composed_rf_taps(k, h, h_rf, decim, offsets_hz=offs,
                                fs_ch=2.4e6)


@pytest.mark.parametrize("k,decim,kind,taps_rf,tpb,c,p_out,n_sm", [
    (3, 2, "none", 5, 4, 2, 7, 132),        # generic instance, ragged P
    (3, 2, "one", 5, 4, 2, 75, 132),        # mixed, two tiles, the window
    #                                         running past the block
    (4, 10, "all", 31, 16, 1, 21, 132),     # own taps only, 2 slices
    (4, 2, "none", 9, 4, 3, 40, 4),         # narrow tiles: many blocks
    (8, 10, "one", 151, 16, 1, 9, 132),     # the A = 17 instance, mixed
    (8, 2, "all", 9, 8, 2, 13, 132),        # own taps, 8 lanes
])
def test_kernel_plan_equals_plain(k, decim, kind, taps_rf, tpb, c, p_out,
                                  n_sm):
    rng = np.random.default_rng(k * 100 + decim + c)
    g = _taps(k, decim, kind, taps_rf, tpb)
    plan = tch.composed_plan(g, decim)
    assert (len(plan.own) == 0) == (kind == "none")
    d = decim * k
    zi = rng.integers(0, 256, (c, 2 * (g.shape[1] - 1)), np.uint8)
    raw = rng.integers(0, 256, (c, 2 * d * p_out), np.uint8)
    want, want_tail = tch.composed_channelize_u8_ref(
        torch.as_tensor(raw), g, torch.as_tensor(zi), decim)
    got, tail = rehearse(raw, zi, g, decim, n_sm)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    assert np.array_equal(tail, want_tail.numpy())


def test_kernel_plan_in_several_passes():
    """Planes that do not fit one pass (d = 640 at K = 64) are staged
    nb at a time; the shared role's slices split each residue."""
    k, decim = 64, 10
    g = _taps(k, decim, "none")
    plan = tch.composed_plan(g, decim)
    geo = tch.composed_geometry(plan, 1, 20)
    assert geo.nb < plan.d and geo.ns_sh % k == 0
    rng = np.random.default_rng(64)
    zi = rng.integers(0, 256, (1, 2 * (g.shape[1] - 1)), np.uint8)
    raw = rng.integers(0, 256, (1, 2 * plan.d * 3), np.uint8)
    want, _ = tch.composed_channelize_u8_ref(
        torch.as_tensor(raw), g, torch.as_tensor(zi), decim)
    got, _ = rehearse(raw, zi, g, decim)
    np.testing.assert_allclose(
        got, want.numpy(), rtol=0,
        atol=TOL_K5_REL * float(np.abs(g).sum(axis=1).max()))


def _vector_staging(lead, n_el, d):
    """The kernel's 16-byte staging walk over a window that lies in raw:
    chunk c holds pairs 8c - lead + w; returns window index -> (plane,
    row) as the kernel stores them."""
    out = {}
    for cidx in range(-(-(lead + n_el) // 8)):
        first = max(8 * cidx - lead, 0)
        j, col = divmod(first, d)
        for w in range(8):
            idx = 8 * cidx - lead + w
            if idx < 0 or idx >= n_el:
                continue
            assert idx not in out
            out[idx] = (d - 1 - col, j)
            col += 1
            if col == d:
                col, j = 0, j + 1
    return out


@pytest.mark.parametrize("lead,rows,d", [(1, 80, 160), (0, 5, 6), (7, 9, 40)])
def test_vector_staging_places_every_sample(lead, rows, d):
    got = _vector_staging(lead, rows * d, d)
    assert sorted(got) == list(range(rows * d))
    for idx, (plane, j) in got.items():
        assert (plane, j) == (d - 1 - idx % d, idx // d)


def test_raw_window_alignment_at_the_receivers_shape():
    """K = 16, decim 10: a tile's window starts 2 bytes past a 16-byte
    boundary of a raw row (ext byte 5,310 = 14 mod 16 from the zi side): the
    lead the vector staging handles is 1 pair for every tile."""
    g = _taps(16, 10, "none")
    plan = tch.composed_plan(g, 10)
    geo = tch.composed_geometry(plan, 8, 15360)
    t1 = g.shape[1] - 1
    for p0 in range(geo.tile * 1, geo.tile * 5, geo.tile):
        e0 = plan.d * (p0 - plan.a_sp + 1) + g.shape[1] - plan.d
        assert e0 >= t1 and (2 * (e0 - t1)) % 16 == 2


# ---------------------------------------------------------------- the plan

def test_plan_zero_offsets_all_shared():
    g = _taps(16, 10, "none")
    plan = tch.composed_plan(g, 10)
    assert plan.shared == tuple(range(16)) and plan.own == ()
    assert plan.a_sp == tch.FIXED_TAPS_PER_PLANE == 17
    assert plan.proto.shape == (160, 17) and plan.own_taps is None
    # the prototype is real and rebuilds every station's taps
    c = np.zeros(160 * 17)
    c.reshape(17, 160)[:] = plan.proto[:, :17].T.astype(np.float64) * 128
    t = np.arange(g.shape[1])
    for k in (0, 5, 15):
        rot = np.exp(2j * np.pi * ((k * t) % 16) / 16)
        np.testing.assert_allclose(c[:g.shape[1]] * rot, g[k], rtol=0,
                                   atol=1e-7 * np.abs(g).max())
    w = plan.twiddle
    np.testing.assert_array_equal(
        w, np.stack([np.cos(2 * np.pi * np.arange(16) / 16),
                     np.sin(2 * np.pi * np.arange(16) / 16)], -1
                    ).astype(np.float32))


def test_plan_one_offset_own_taps_alone():
    g = _taps(16, 10, "one")
    plan = tch.composed_plan(g, 10)
    assert plan.own == (8,) and plan.shared == tuple(
        j for j in range(16) if j != 8)
    assert plan.own_taps.shape == (160, 17, 1, 2)
    # plane b, tap a of station 8 is g[8, 160 a + b] / 128
    np.testing.assert_array_equal(
        plan.own_taps[3, 2, 0], np.array([g[8, 323].real, g[8, 323].imag],
                                         np.float64).astype(np.float32)
        / np.float32(128))


def test_plan_perturbed_tap_goes_own():
    g = _taps(8, 10, "none").copy()
    g[3, 100] += 1e-6 * np.abs(g).max()
    plan = tch.composed_plan(g, 10)
    assert plan.own == (3,) and len(plan.shared) == 7


def test_plan_random_taps_all_own():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((6, 50)) + 1j * rng.standard_normal((6, 50))
    plan = tch.composed_plan(g, 3)
    assert plan.shared == () and plan.own == tuple(range(6))
    assert plan.proto is None and plan.a_sp % 4 == 0


def test_plan_is_made_once_per_array():
    g = _taps(4, 10, "one")
    assert tch.composed_plan(g, 10) is tch.composed_plan(g, 10)
    assert tch.composed_plan(g.copy(), 10) is not tch.composed_plan(g, 10)


def test_geometry_fills_the_card():
    """Two blocks per SM at 8 and at 1 capture; the shared role's tile
    within one pass of the block's threads; shared memory of two blocks."""
    for kind in ("none", "one", "all"):
        g = _taps(16, 10, kind)
        plan = tch.composed_plan(g, 10)
        for n_cap in (8, 1):
            geo = tch.composed_geometry(plan, n_cap, 15360)
            assert geo.nb == plan.d
            assert n_cap * geo.n_tiles * geo.roles >= 2 * 132
            assert geo.smem <= tch.K5_SMEM
            assert geo.plane_elems >= geo.nb * geo.pitch
    geo = tch.composed_geometry(tch.composed_plan(_taps(16, 10, "none"), 10),
                                8, 15360)
    assert (geo.tile, geo.ns_sh, geo.roles) == (64, 32, 1)
