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

The two-stage role (every station, when g's factors make it the least
work): per capture tile, the slot bank at the slot rate (16 real taps per
residue over K polyphase planes, a radix-2 DFT across the residues) into
shared memory in stage B's layout, then each station's RF FIR over decim
planes in half-planes of 8 taps, the slices' partial sums added in order.
Its rehearsal rounds every operation to float32 (no FMA emulation): it
holds the indexing, at the same tolerance.  Given the residual NCO's
phase and ramp, its epilogue turns each output p of station j by
exp(j (phase_j + ramp_j[p])) as it writes it, held against the plain
version followed by the stock mix (``residual_mix``).  The tests marked
``gpu`` run the kernel itself and skip without a card.
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


# ------------------------------------------------------ the two-stage role

WB8_OFFSETS = [200e3, -600e3, 800e3, -200e3, 400e3, 0.0, -800e3, 600e3]


def _factored(k, offsets, decim=10, tpb=16, h_rf=None):
    h_rf = rf_lpf_taps(MODE0) if h_rf is None else h_rf
    return tch.composed_rf_factors(k, tch.channelizer_taps(k, tpb), h_rf,
                                   decim, offsets_hz=offsets, fs_ch=2.4e6)


def _bit_reversed(i, k):
    o, m = 0, 1
    while m < k:
        o, i, m = (o << 1) | (i & 1), i >> 1, m << 1
    return o


def _dft(x, tw):
    """The kernel's ``dft``: X_k = sum_r W^{k r} x_r, radix-2 decimation in
    frequency over the list ``x`` of K complex64 arrays."""
    k, x = len(x), list(x)
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    half = k // 2
    while half >= 1:
        for s in range(0, k, 2 * half):
            for j in range(half):
                u, w = x[s + j], x[s + j + half]
                x[s + j], v = u + w, u - w
                x[s + j + half] = (v if j == 0
                                   else twc[j * (k // (2 * half))] * v)
        half //= 2
    out = [None] * k
    for i in range(k):
        out[_bit_reversed(i, k)] = x[i]
    return out


def rehearse_two_stage(raw, zi, g, decim, factors, n_sm=132, stations=None,
                       mix=None):
    """What the two-stage kernel writes for (B, 2n) bytes: (y, tail);
    ``stations``: g's rows are S stations over K slots; ``mix``: the
    residual NCO's (phase (S,), ramp (S, P)) float32 arrays, which the
    epilogue turns each output by."""
    plan = tch.composed_plan(g, decim, factors, stations)
    assert plan.two_stage
    n_cap = raw.shape[0]
    k, s_n, taps = plan.k, plan.stations, g.shape[1]
    slot_of = list(plan.slot_of)
    t1, n = taps - 1, raw.shape[1] // 2
    d = decim * k
    p_out = n // d
    geo = tch.two_stage_geometry(plan, n_cap, p_out, n_sm)
    ta, tile = tch.TWO_STAGE_TAPS, geo.tile
    qb = tile + ta - 1                       # stage B plane rows
    ms = decim * qb                          # slot-rate samples a tile
    ms_pad = -(-ms // R) * R
    rows_a = ms_pad + ta - 1
    assert rows_a <= geo.pitch_a and qb <= geo.bp and decim * geo.bp <= geo.kp
    assert geo.pitch_a % 2 == geo.bp % 2 == geo.kp % 2 == 1
    if s_n == k:
        # one station a slot: stage B's items in one turn of the threads,
        # its taps and partial sums within the dead stage-A planes
        assert k * (tile // R) * geo.ns <= tch.K5_THREADS
        assert geo.a_elems == k * geo.pitch_a
    assert geo.smem == 8 * (geo.a_elems + k * geo.kp) <= tch.K5_SMEM
    # stage B's taps and the partial sums fit the stage-A space
    assert decim * ta * s_n + geo.ns * s_n * (tile + 1) <= geo.a_elems
    assert geo.a_elems >= k * geo.pitch_a
    ext = np.concatenate([zi, raw], axis=1).astype(np.int64) - 128
    ext_c = (ext[:, 0::2] + 1j * ext[:, 1::2]).astype(np.complex64)
    fb = (plan.stage_b[..., 0] + 1j * plan.stage_b[..., 1]).astype(
        np.complex64)                         # (decim, ta, S)
    y = np.full((n_cap, s_n, 2, p_out), np.nan, np.float32)
    for tile_idx in range(geo.n_tiles):
        p0 = tile_idx * tile
        # stage A's plane r, row j: ext[e0 + K j + (K - 1 - r)]
        e0 = d * (p0 - ta) + taps - k * (ta - 1)
        e = e0 + np.arange(rows_a)[None, :] * k + (k - 1
                                                    - np.arange(k)[:, None])
        inside = (e >= 0) & (e < t1 + n)
        planes = np.where(inside[None], ext_c[:, np.clip(e, 0, t1 + n - 1)],
                          np.complex64(0))            # (B, K, rows_a)
        u = np.zeros((n_cap, k, ms_pad), np.complex64)
        for a in range(ta):
            u = u + plan.stage_a[a][None, :, None] * planes[
                :, :, ta - 1 - a: ta - 1 - a + ms_pad]
        s = np.stack(_dft([u[:, r, :ms] for r in range(k)], plan.twiddle), 1)
        # stage B's plane b, row i: s[decim i + decim - 1 - b]; each
        # station reads its slot's
        sb = s.reshape(n_cap, k, qb, decim)[..., ::-1].swapaxes(-1, -2)
        sb = sb[:, slot_of]
        tot = None
        for sl in range(geo.ns):
            part = np.zeros((n_cap, s_n, tile), np.complex64)
            for unit in range(sl, 2 * decim, geo.ns):
                b, half = unit >> 1, unit & 1
                for t in range(ta // 2):
                    a = (ta // 2) * half + t
                    part = part + fb[b, a][None, :, None] * sb[
                        :, :, b, ta - 1 - a: ta - 1 - a + tile]
            tot = part if tot is None else tot + part
        q = np.arange(tile)
        valid = p0 + q < p_out
        re, im = tot.real[..., valid], tot.imag[..., valid]
        if mix is not None:
            # the epilogue: ang = phase_j + ramp_j[p] and the turn, each
            # product and sum rounded to float32
            phase, ramp = mix
            ang = phase[:, None] + ramp[:, (p0 + q)[valid]]
            cs, sn = np.cos(ang), np.sin(ang)
            assert ang.dtype == cs.dtype == np.float32
            re, im = re * cs - im * sn, re * sn + im * cs
        y[:, :, 0, (p0 + q)[valid]] = re
        y[:, :, 1, (p0 + q)[valid]] = im
    return y, np.concatenate([zi, raw], axis=1)[:, 2 * n:]


@pytest.mark.parametrize("k,offsets,c,p_out,n_sm,short", [
    (8, WB8_OFFSETS, 2, 130, 132, False),    # the cell's plan: 3 tiles, the
    #                                          last ragged; the first reads zi
    (16, "all", 1, 60, 132, False),          # the smoke's every-offset case
    (4, [1e5, -2e5, 3e5, 5e4], 2, 70, 132, False),
    (8, WB8_OFFSETS, 1, 40, 4, False),       # one tile
    (8, WB8_OFFSETS, 2, 70, 132, True),      # 12 taps a branch, 101 RF taps:
    #                                          both stages zero-padded
])
def test_two_stage_plan_equals_plain(k, offsets, c, p_out, n_sm, short):
    if offsets == "all":
        offsets = np.linspace(-90e3, 90e3, k) + 1e3
    g, factors = (_factored(k, offsets, tpb=12, h_rf=np.hanning(101) / 50)
                  if short else _factored(k, offsets))
    rng = np.random.default_rng(k * 10 + c)
    d = 10 * k
    zi = rng.integers(0, 256, (c, 2 * (g.shape[1] - 1)), np.uint8)
    raw = rng.integers(0, 256, (c, 2 * d * p_out), np.uint8)
    want, want_tail = tch.composed_channelize_u8_ref(
        torch.as_tensor(raw), g, torch.as_tensor(zi), 10)
    got, tail = rehearse_two_stage(raw, zi, g, 10, factors, n_sm)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    assert np.array_equal(tail, want_tail.numpy())


@pytest.mark.parametrize("k,n_cap,tile", [(8, 128, 56), (16, 8, 24),
                                          (8, 1, 56)])
def test_two_stage_geometry_fills_the_card(k, n_cap, tile):
    """Two blocks an SM by shared memory; the grid at least two blocks an
    SM; the tile of least cost an output at the receivers' 15,360."""
    g, factors = _factored(k, np.linspace(-90e3, 90e3, k) + 1e3)
    plan = tch.composed_plan(g, 10, factors)
    geo = tch.two_stage_geometry(plan, n_cap, 15360)
    assert geo.tile == tile and geo.smem <= tch.K5_SMEM
    assert n_cap * geo.n_tiles >= 2 * 132
    assert k * geo.tile // R * geo.ns <= tch.K5_THREADS


# -------------------------------------------------- the kernel, on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,n_cap", [(8, 128), (16, 8)])
def test_two_stage_kernel_on_the_card(card, k, n_cap):
    """The two-stage role against the plain version over two chained
    blocks at the wideband cell's shape (K = 8, wideband8's band plan, 128
    captures of 8 x 307,200 bytes) and the smoke's (K = 16, every station
    offset, 8 captures): within TOL_K5_REL * max sum|g|, the byte tail
    exact, one launch a call under its own key."""
    from rtsdr_tpu_torch.ops import _cuda

    offsets = (WB8_OFFSETS if k == 8
               else np.linspace(-90e3, 90e3, k) + 1e3)
    g, factors = _factored(k, offsets)
    assert tch.composed_plan(g, 10, factors).two_stage
    gen = torch.Generator(device=card).manual_seed(20)
    zi = tch.composed_zi_u8(g.shape[1], (n_cap,), card)
    tol = TOL_K5_REL * float(np.abs(g).sum(axis=1).max())
    for _ in range(2):
        raw = torch.randint(0, 256, (n_cap, k * MODE0.block_size),
                            generator=gen, device=card, dtype=torch.uint8)
        _cuda.reset_launch_counts()
        y, new_zi = tch.composed_channelize_u8(raw, g, zi, 10, factors)
        assert _cuda.launch_counts() == {"channelizer.composed_two_stage": 1}
        want, want_zi = tch.composed_channelize_u8_ref(raw, g, zi, 10,
                                                       block=32)
        torch.cuda.synchronize()
        assert float((y - want).abs().max()) <= tol
        assert torch.equal(new_zi, want_zi)
        zi = new_zi
        del want
