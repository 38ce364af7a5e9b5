"""CPU rehearsal of the mixer + resampler + RRC kernel's plan
(``csrc/resample_rrc.cu``, K4).

The kernel runs only on a card, so what it computes is re-derived here in
numpy, index for index, and held against the plain version
(``resample_mul2_rrc_ref``) at the tolerances ``chip_smoke.py`` holds the
kernel to on the card: rrc and the carried RRC state 5e-6 * max|ref|, the
carried resampler state ``new_zi`` bit for bit.

The plan: one block per (row, tile of ``tile`` RRC outputs).  The block
computes the resampler outputs [m0 - q_r + 1, m0 + own) (q_r = the RRC's
taps rounded up to a multiple of 4; outputs before the row come from the
carried RRC state).  The mixed window x = 2 * e * n_b is staged transposed,
x index ilo + row * down + col at ``col * L + row`` (L odd), so that the 32
lanes of a warp, whose outputs are ``up`` apart (one phase, one broadcast
tap), read ``down`` samples apart from distinct banks.  Output m of phase
ph = m*down % up, i0 = m*down // up, sums

    r[m] = sum_j hp_ph[j] * x[i0 - j],   hp_ph[j] = h[ph + up*j],

j ascending (zeros staged before x[0]), then the carried zi terms of the
first outputs (a warp's strided partial sums and shuffle tree, zi staged
in shared memory one branch at a time), then the gain.  A thread makes R = 4 outputs of one phase, Qs * up apart.  The RRC
is a stride-1 FIR over the slots, 4 consecutive outputs per thread from a
sliding register window, taps in the plain version's order.  The last tile
also writes ``new_zi``, the zero-stuffed tail of the mixed stream.

Fused multiply-adds are emulated in float64 (the product of two float32
values is exact there) and rounded to float32 once per step.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0, MODE1_RDS
from rtsdr_tpu_torch.ops import coeffs
from rtsdr_tpu_torch.ops import cuda_resample as tres
from rtsdr_tpu_torch.pipeline.rds import composed_resampler_taps

torch.set_num_threads(1)

R = 4                            # outputs of one phase per thread
N_SM = 132
SMEM_TWO_BLOCKS = 113 * 1024
TILES = (2048, 1024, 512, 256, 128)
RRC_H = coeffs.rrc_taps(MODE0.rds.rrc_fs, MODE0.rds.rrc_taps,
                        MODE0.rds.rrc_beta, MODE0.rds.symbol_rate)
COMB0 = composed_resampler_taps(MODE0)           # 3,001 taps, x19/80
COMB1 = composed_resampler_taps(MODE1_RDS)       # 9,003 taps, x57/250


def _r4(n):
    return -(-n // 4) * 4


def plan(tile, taps, up, down, rtaps):
    """(q_r, qp, s_cap, lcap, shared bytes) of a block that owns ``tile``
    RRC outputs: the RRC's padded taps, taps per phase, resampler slots,
    rows of the transposed x window (odd), dynamic shared memory."""
    t1 = taps - 1
    q_r = _r4(rtaps)
    qp = t1 // up + 1
    s_cap = tile + q_r + 4
    span = ((s_cap - 1) * down) // up + 2 + -(-t1 // up)
    lcap = max(span // down + 2, -(-t1 // (2 * down)))  # + a branch's zi
    lcap += 1 - lcap % 2
    smem = 4 * (2 * lcap * down + up * qp + 2 * s_cap + q_r)
    return q_r, qp, s_cap, lcap, smem


def geometry(c, m, taps, up, down, rtaps, n_sm=N_SM):
    """The tile ``rtsdr_resample_rrc`` picks: the widest that still gives
    two blocks per SM within the shared memory of two blocks per SM, else
    the narrowest."""
    for tile in TILES:
        if (c * -(-m // tile) >= 2 * n_sm
                and plan(tile, taps, up, down, rtaps)[4] <= SMEM_TWO_BLOCKS):
            return tile
    return TILES[-1]


def _fma(a, b, acc):
    return (a.astype(np.float64) * b.astype(np.float64) + acc
            ).astype(np.float32)


def _carried(h, zi_b, pos, t1):
    """sum_{k = pos+1 .. t1} h[k] * zi_b[pos + t1 - k] as a warp sums it:
    lane l takes k = pos+1+l, +32, ... in four running sums (k, k+32, k+64,
    k+96 per round of 128), adds them pairwise, then a shuffle tree.  The
    32 lanes side by side, each in its own order."""
    c = zi_b.shape[0]
    h32 = np.asarray(h, np.float32)
    lane = np.arange(32)
    a = np.zeros((4, 32, c), np.float32)
    k = pos + 1 + lane

    def step(q, kk, act):
        kc = np.where(act, kk, pos + 1)
        upd = _fma(h32[kc][:, None], zi_b[:, pos + t1 - kc].T, a[q])
        a[q] = np.where(act[:, None], upd, a[q])

    while (act := k + 96 <= t1).any():
        for q in range(4):
            step(q, k + 32 * q, act)
        k = np.where(act, k + 128, k)
    while (act := k <= t1).any():
        step(0, k, act)
        k = np.where(act, k + 32, k)
    lanes = (a[0] + a[1]) + (a[2] + a[3])
    for d in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[lane ^ d]
    return lanes[0]


def rehearse(e, ni, nq, h, zi, g, rrc_zi, up, down, gain, tile):
    """What the kernel writes for (C, N) inputs: (rrc, new_zi, new_rrc_zi)."""
    h = np.asarray(h, np.float64).astype(np.float32)
    g = np.asarray(g, np.float64).astype(np.float32)
    c, n = e.shape
    taps, rtaps = len(h), len(g)
    t1, t1r = taps - 1, rtaps - 1
    m_tot = n * up // down
    q_r, qp, s_cap, lcap, _ = plan(tile, taps, up, down, rtaps)
    hp = np.zeros((up, qp), np.float32)                  # phase planes
    for p in range(up):
        js = np.arange(qp)
        ok = p + up * js <= t1
        hp[p, ok] = h[p + up * js[ok]]
    gr = np.zeros(q_r, np.float32)                       # reversed RRC taps
    for u in range(q_r):
        if q_r - 1 - u < rtaps:
            gr[u] = g[q_r - 1 - u]
    mixed = [(np.float32(2.0) * e) * ni, (np.float32(2.0) * e) * nq]
    y = np.full((c, 2, m_tot), np.nan, np.float32)
    new_rrc_zi = np.full((c, 2, t1r), np.nan, np.float32)
    gain = np.float32(gain)
    for m0 in range(0, m_tot, tile):
        own = min(tile, m_tot - m0)
        slot0 = m0 - (q_r - 1)
        m_first, m_end = max(slot0, 0), m0 + own
        ilo = (m_first * down) // up - -(-t1 // up)
        ihi = ((m_end - 1) * down) // up
        assert (ihi - ilo) // down + 1 <= lcap
        # the transposed window: index ilo + row*down + col at col*L + row
        rel = np.arange(lcap * down)
        xi = ilo + rel
        inside = (xi >= 0) & (xi < n)
        xs = []
        for mb in mixed:
            v = np.zeros((c, lcap * down), np.float32)
            v[:, inside] = mb[:, xi[inside]]
            t = np.zeros((c, down * lcap), np.float32)
            t[:, (rel % down) * lcap + rel // down] = v
            xs.append(t)
        slots = [np.full((c, s_cap), np.nan, np.float32) for _ in (0, 1)]
        # resampler: unit (p', qb) makes outputs q = qb + k*Qs, k < R
        n_q = -(-(m_end - m_first) // up)
        q_s = -(-n_q // R)
        for pp in range(up):
            mb0 = m_first + pp
            ph = (mb0 * down) % up
            rel0 = (mb0 * down) // up - ilo
            col0, row0 = rel0 % down, rel0 // down
            nj = (t1 - ph) // up + 1 if ph <= t1 else 0
            q = np.arange(q_s)[:, None] + q_s * np.arange(R)[None, :]
            mm = mb0 + up * q                                  # (Qs, R)
            valid = mm < m_end
            # an output past the tile reads its unit's first row (kept
            # inside the window), and is not written
            rowk = row0 + np.where(valid, q, q[:, :1])
            acc = [np.zeros((c,) + q.shape, np.float32) for _ in (0, 1)]
            col, wraps = col0, 0
            for j in range(nj):
                a = col * lcap + rowk - wraps
                for b in (0, 1):
                    acc[b] = _fma(hp[ph, j], xs[b][:, a], acc[b])
                col -= 1
                if col < 0:
                    col, wraps = down - 1, wraps + 1
            for b in (0, 1):
                slots[b][:, mm[valid] - slot0] = acc[b][:, valid]
        # the carried resampler state: outputs with m*down < t1
        for mm in range(m_first, min(m_end, -(-t1 // down))):
            for b in (0, 1):
                s = mm - slot0
                slots[b][:, s] = slots[b][:, s] + _carried(
                    h, zi[:, b], mm * down, t1)
        for b in (0, 1):
            sl = slice(m_first - slot0, m_end - slot0)
            slots[b][:, sl] = slots[b][:, sl] * gain
            # before the row: the carried RRC state, zero further back
            for s in range(m_first - slot0):
                mm = slot0 + s
                slots[b][:, s] = rrc_zi[:, b, t1r + mm] if mm >= -t1r else 0
        if m_end == m_tot:
            for b in (0, 1):
                new_rrc_zi[:, b] = slots[b][:, m_tot - t1r - slot0:
                                           m_tot - slot0]
        # RRC: output m0 + o sums gr[u] * slot[o + u], u descending
        o = np.arange(own)
        for b in (0, 1):
            acc = np.zeros((c, own), np.float32)
            for u in range(q_r - 1, -1, -1):
                acc = _fma(gr[u], slots[b][:, o + u], acc)
            y[:, b, m0:m0 + own] = acc
    # the zero-stuffed tail of the mixed stream
    new_zi = np.zeros((c, 2, t1), np.float32)
    pos = n * up - t1 + np.arange(t1)
    on = pos % up == 0
    for b in (0, 1):
        new_zi[:, b, on] = mixed[b][:, pos[on] // up]
    return y, new_zi, new_rrc_zi


def _inputs(rng, c, n, taps, dense_zi):
    """A band-limited extract and a unit-modulus carrier (the shapes of the
    receiver's RDS branch); ``dense_zi``: an arbitrary carried tail (a time
    shard's), else the zero-stuffed one the serial receiver carries."""
    t = np.arange(n)
    e = np.stack([np.cos(2 * np.pi * 0.2375 * t + k) * 0.3
                  + 0.01 * rng.standard_normal(n) for k in range(c)])
    ph = 2 * np.pi * 0.2375 * t[None] + rng.uniform(0, 6, (c, 1))
    zi = rng.standard_normal((c, 2, taps - 1)) * 0.3
    if not dense_zi:
        zi[..., (np.arange(taps - 1) - (taps - 1)) % 19 != 0] = 0.0
    f = lambda a: np.ascontiguousarray(a, np.float32)
    return (f(e), f(np.cos(ph)), f(np.sin(ph)), f(zi),
            f(rng.standard_normal((c, 2, len(RRC_H) - 1))))


@pytest.mark.parametrize("c,n,comb,up,down,dense", [
    (2, 15360, COMB0, 19, 80, False),       # MODE0's block, zero-stuffed zi
    (1, 15360, COMB0, 19, 80, True),        # C = 1 geometry, dense zi
    (2, 4000, COMB1, 57, 250, True),        # x57/250, 9,003 taps
    (300, 1600, COMB0, 19, 80, False)])     # wide tiles, one ragged tile
def test_kernel_plan_equals_plain(c, n, comb, up, down, dense):
    rng = np.random.default_rng(c + n + up)
    e, ni, nq, zi, rzi = _inputs(rng, c, n, len(comb), dense)
    m = n * up // down
    tile = geometry(c, m, len(comb), up, down, len(RRC_H))
    if c == 300:
        assert tile == 2048
    got = rehearse(e, ni, nq, comb, zi, RRC_H, rzi, up, down, float(up),
                   tile)
    t = torch.as_tensor
    ref = tres.resample_mul2_rrc_ref(t(e), t(ni), t(nq), comb, t(zi), RRC_H,
                                     t(rzi), up, down)
    scale = float(ref[0].abs().max())
    np.testing.assert_allclose(got[0], ref[0].numpy(), rtol=0,
                               atol=5e-6 * scale)
    np.testing.assert_allclose(got[2], ref[2].numpy(), rtol=0,
                               atol=5e-6 * scale)
    assert np.array_equal(got[1], ref[1].numpy())


@pytest.mark.parametrize("n,comb,up", [(15360, COMB0, 19), (16000, COMB1, 57),
                                       (160, COMB0, 19)])
def test_kernel_tail_is_the_reference_tail_bit_for_bit(n, comb, up):
    """The kernel's ``new_zi`` plan (position p of the zero-stuffed tail is
    (2e) * n_b at p / up where up divides p, else +0) is
    ``resample_mul2_tail`` bit for bit, bytes included."""
    rng = np.random.default_rng(n)
    e, ni, nq, _, _ = _inputs(rng, 3, n, len(comb), False)
    t1 = len(comb) - 1
    mixed = [(np.float32(2.0) * e) * ni, (np.float32(2.0) * e) * nq]
    want = tres.resample_mul2_tail(torch.as_tensor(e), torch.as_tensor(ni),
                                   torch.as_tensor(nq), t1, up).numpy()
    got = np.zeros_like(want)
    pos = n * up - t1 + np.arange(t1)
    on = pos % up == 0
    for b in (0, 1):
        got[:, b, on] = mixed[b][:, pos[on] // up]
    assert got.tobytes() == want.tobytes()


def test_geometry_fills_the_card():
    """Wide tiles at C >= 1,024 within two blocks per SM (x57/250's taps
    take more shared memory: half the tile); C = 1 spread over the card."""
    assert geometry(1024, 3648, 3001, 19, 80, 151) == 2048
    assert geometry(1024, 3648, 9003, 57, 250, 151) == 1024
    assert geometry(128, 3648, 3001, 19, 80, 151) == 1024    # wideband
    assert geometry(1, 3648, 3001, 19, 80, 151) == 128
    assert -(-3648 // 128) == 29
    for taps, up, down in ((3001, 19, 80), (9003, 57, 250)):
        for tile in TILES:
            smem = plan(tile, taps, up, down, 151)[4]
            assert smem <= 227 * 1024
    # the transposed window has an odd row count: its staging writes,
    # consecutive x indices L apart, fall on distinct banks
    lcap = plan(2048, 3001, 19, 80, 151)[3]
    assert lcap % 2 == 1
    assert len({(lane * lcap) % 32 for lane in range(32)}) == 32


# ------------------------------------------------------------------- K6
# The mixer + resampler kernel (``resample_mul2``, K6) is K4's block without
# the RRC stage: a block owns outputs [m0, m0 + tile) of one stacked row; the
# units of a phase are not padded (q_w = q_s); `pair` makes R outputs of both
# branches per unit, `split` 2R outputs of one branch (the branch outermost).
# Segmented form (segments = T, rows (segment, channel)): x < 0 of a row of
# segment s > 0 is its left neighbour's x[n + i], mixed in the window;
# segment 0's rows add the carried zi; the last segment's rows write new_zi.

MIX_TILE_MAX = 1024


def mix_plan(tile, taps, up, down):
    """(qp, lcap, shared bytes) of a K6 block that owns ``tile`` outputs."""
    t1 = taps - 1
    qp = t1 // up + 1
    span = ((tile - 1) * down) // up + 2 + -(-t1 // up)
    lcap = max(span // down + 2, (t1 + 2 * down - 1) // (2 * down))
    lcap += 1 - lcap % 2
    return qp, lcap, 4 * (2 * lcap * down + up * qp + 2 * tile)


def mix_geometry(rows, m, taps, up, down, split, n_sm=N_SM):
    """The tile ``rtsdr_resample_mix`` picks: equal tiles, as few as give
    two blocks per SM with every unit in one pass of the block's 256
    threads and the shared memory of two blocks per SM; at least 8."""
    n_out = 2 * R if split else R
    n_t = -(-m // MIX_TILE_MAX)
    while True:
        tile = -(-m // n_t)
        smem = mix_plan(tile, taps, up, down)[2]
        units = (2 if split else 1) * up * -(-(-(-tile // up)) // n_out)
        if ((units <= 256 and smem <= SMEM_TWO_BLOCKS
             and rows * -(-m // tile) >= 2 * n_sm) or tile <= 8 or n_t >= m):
            return tile
        n_t += 1


def rehearse_mix(e, ni, nq, h, zi, up, down, gain, tile, segments, split):
    """What K6 writes for (T*C, N) rows: (y (T*C, 2, M), new_zi (C, 2, t1))."""
    h = np.asarray(h, np.float64).astype(np.float32)
    rows, n = e.shape
    seg_n = segments or 1
    c = rows // seg_n
    taps = len(h)
    t1 = taps - 1
    m_tot = n * up // down
    n_out = 2 * R if split else R
    qp, lcap, _ = mix_plan(tile, taps, up, down)
    hp = np.zeros((up, qp), np.float32)
    for p in range(up):
        js = np.arange(qp)
        ok = p + up * js <= t1
        hp[p, ok] = h[p + up * js[ok]]
    mixed = [(np.float32(2.0) * e) * ni, (np.float32(2.0) * e) * nq]
    y = np.full((rows, 2, m_tot), np.nan, np.float32)
    gain = np.float32(gain)
    for s in range(seg_n):
        rs = slice(s * c, (s + 1) * c)
        for m0 in range(0, m_tot, tile):
            m_end = min(m0 + tile, m_tot)
            ilo = (m0 * down) // up - -(-t1 // up)
            assert ((m_end - 1) * down // up - ilo) // down + 1 <= lcap
            rel = np.arange(lcap * down)
            xi = ilo + rel
            xs = []
            for mb in mixed:
                v = np.zeros((c, lcap * down), np.float32)
                own = (xi >= 0) & (xi < n)
                v[:, own] = mb[rs][:, xi[own]]
                if s > 0:                 # the left neighbour's inputs
                    halo = xi < 0
                    v[:, halo] = mb[s * c - c:s * c][:, n + xi[halo]]
                t = np.zeros((c, down * lcap), np.float32)
                t[:, (rel % down) * lcap + rel // down] = v
                xs.append(t)
            slots = [np.full((c, tile), np.nan, np.float32) for _ in (0, 1)]
            n_q = -(-(m_end - m0) // up)
            q_s = -(-n_q // n_out)
            for pp in range(up):
                mb0 = m0 + pp
                ph = (mb0 * down) % up
                rel0 = (mb0 * down) // up - ilo
                col0, row0 = rel0 % down, rel0 // down
                nj = (t1 - ph) // up + 1 if ph <= t1 else 0
                q = np.arange(q_s)[:, None] + q_s * np.arange(n_out)[None, :]
                mm = mb0 + up * q
                valid = mm < m_end
                rowk = row0 + np.where(valid, q, q[:, :1])
                for b in (0, 1):     # pair: both per unit, split: one each
                    acc = np.zeros((c,) + q.shape, np.float32)
                    col, wraps = col0, 0
                    for j in range(nj):
                        acc = _fma(hp[ph, j], xs[b][:, col * lcap + rowk
                                                    - wraps], acc)
                        col -= 1
                        if col < 0:
                            col, wraps = down - 1, wraps + 1
                    slots[b][:, mm[valid] - m0] = acc[:, valid]
            if s == 0:
                for mm in range(m0, min(m_end, -(-t1 // down))):
                    for b in (0, 1):
                        slots[b][:, mm - m0] = slots[b][:, mm - m0] + _carried(
                            h, zi[:, b], mm * down, t1)
            for b in (0, 1):
                y[rs, b, m0:m_end] = slots[b][:, :m_end - m0] * gain
    new_zi = np.zeros((c, 2, t1), np.float32)
    pos = n * up - t1 + np.arange(t1)
    on = pos % up == 0
    last = slice((seg_n - 1) * c, seg_n * c)
    for b in (0, 1):
        new_zi[:, b, on] = mixed[b][last][:, pos[on] // up]
    return y, new_zi


@pytest.mark.parametrize("segments,c,n,comb,up,down,split,n_sm", [
    (None, 2, 1600, COMB0, 19, 80, False, N_SM),   # a block, dense zi
    (None, 1, 15360, COMB0, 19, 80, True, 2),      # 4 tiles of 912, split
    (3, 2, 480, COMB0, 19, 80, False, N_SM),       # segmented, 3 chunks
    (2, 1, 4000, COMB1, 57, 250, True, 2),         # segmented x57/250
    (4, 1, 3840, COMB0, 19, 80, True, N_SM)])      # T = 4, one station
def test_mix_plan_equals_plain(segments, c, n, comb, up, down, split, n_sm):
    rng = np.random.default_rng(n + up + (segments or 0))
    rows = c * (segments or 1)
    e, ni, nq, _, _ = _inputs(rng, rows, n, len(comb), True)
    zi = _inputs(rng, c, n, len(comb), True)[3]
    m = n * up // down
    tile = mix_geometry(rows, m, len(comb), up, down, split, n_sm)
    got = rehearse_mix(e, ni, nq, comb, zi, up, down, float(up), tile,
                       segments, split)
    t = torch.as_tensor
    lead = (segments, c) if segments else (c,)
    sh = lambda a: t(a.reshape(*lead, n))
    if segments:
        ref = tres.resample_mul2_segments_ref(sh(e), sh(ni), sh(nq), comb,
                                              t(zi), up, down)
    else:
        ref = tres.resample_mul2_ref(t(e), t(ni), t(nq), comb, t(zi), up,
                                     down)
    want = ref[0].numpy().reshape(rows, 2, m)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got[0], want, rtol=0, atol=5e-6 * scale)
    assert got[1].tobytes() == ref[1].numpy().tobytes()


def test_mix_geometry_fills_the_card():
    """Equal tiles with every unit in one pass: the stacked T = 4 rows take
    one tile of 912, a 15,360-sample block four; one station at T = 4
    still gives two blocks per SM."""
    assert mix_geometry(4096, 912, 3001, 19, 80, False) == 912
    assert mix_geometry(4096, 912, 3001, 19, 80, True) == 912
    assert mix_geometry(1024, 3648, 3001, 19, 80, False) == 912
    assert mix_geometry(4096, 912, 9003, 57, 250, False) == 912
    tile = mix_geometry(4, 912, 3001, 19, 80, False)
    assert 4 * -(-912 // tile) >= 264
    for rows, m, taps, up, down in ((4096, 912, 3001, 19, 80),
                                    (4096, 912, 9003, 57, 250),
                                    (1024, 3648, 3001, 19, 80)):
        for split in (False, True):
            tile = mix_geometry(rows, m, taps, up, down, split)
            assert mix_plan(tile, taps, up, down)[2] <= SMEM_TWO_BLOCKS
            n_out = 2 * R if split else R
            assert (2 if split else 1) * up * -(-(-(-tile // up))
                                                // n_out) <= 256


def _mix_warp_banks(rows, m, taps, up, down, split):
    """(lcap, most distinct words a warp's first window reads put on one
    bank) over every tile and warp of K6's block at this shape: unit (pp,
    qb) of branch br reads word col * lcap + row + qb of its branch's
    transposed window, as ``resample_units`` does."""
    tile = mix_geometry(rows, m, taps, up, down, split)
    lcap = mix_plan(tile, taps, up, down)[1]
    t1, n_out = taps - 1, 2 * R if split else R
    worst = 0
    for m0 in range(0, m, tile):
        m_end = min(m0 + tile, m)
        ilo = (m0 * down) // up - -(-t1 // up)
        q_s = -(-(-(-(m_end - m0) // up)) // n_out)
        words = []
        for unit in range((2 if split else 1) * up * q_s):
            br, uu = divmod(unit, up * q_s)
            pp, qb = divmod(uu, q_s)
            if m0 + pp + up * qb >= m_end:
                words.append(None)
                continue
            rel = (m0 + pp) * down // up - ilo
            words.append(br * lcap * down + (rel % down) * lcap
                         + rel // down + qb)
        for w in range(0, len(words), 32):
            lanes = {a for a in words[w:w + 32] if a is not None}
            per_bank = np.bincount([a % 32 for a in lanes], minlength=32)
            worst = max(worst, int(per_bank.max()))
    return lcap, worst


@pytest.mark.parametrize("rows,m,taps,up,down,split,most", [
    (4096, 912, 3001, 19, 80, False, 2),    # T = 4 stacked, pair
    (4096, 912, 3001, 19, 80, True, 4),     # split
    (4096, 912, 9003, 57, 250, False, 4),   # MODE1_RDS T = 4, pair
    (4096, 912, 9003, 57, 250, True, 4),    # split
    (1024, 3648, 3001, 19, 80, False, 2),   # 1,024 x 15,360, pair
    (1024, 3648, 3001, 19, 80, True, 4)])   # split
def test_mix_window_spreads_banks(rows, m, taps, up, down, split, most):
    """K6's transposed window at the receivers' shapes: an odd row count
    puts a warp's staging writes (consecutive x indices, lcap words apart)
    on 32 distinct banks, and a warp's window reads (consecutive rows
    within a phase, phases down/up columns apart) on at most ``most``
    distinct words per bank."""
    lcap, worst = _mix_warp_banks(rows, m, taps, up, down, split)
    assert lcap % 2 == 1
    assert len({(lane * lcap) % 32 for lane in range(32)}) == 32
    assert worst == most
