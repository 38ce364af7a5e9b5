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
    k+96 per round of 128), adds them pairwise, then a shuffle tree."""
    c = zi_b.shape[0]
    lanes = np.zeros((32, c), np.float32)
    for lane in range(32):
        a = [np.zeros(c, np.float32) for _ in range(4)]
        k = pos + 1 + lane
        while k + 96 <= t1:
            for q in range(4):
                kk = k + 32 * q
                a[q] = _fma(np.float32(h[kk]), zi_b[:, pos + t1 - kk], a[q])
            k += 128
        while k <= t1:
            a[0] = _fma(np.float32(h[k]), zi_b[:, pos + t1 - k], a[0])
            k += 32
        lanes[lane] = (a[0] + a[1]) + (a[2] + a[3])
    for d in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ d]
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
