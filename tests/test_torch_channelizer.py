"""The port's channelizer (``rtsdr_tpu_torch/ops/channelizer.py``) and PSD
estimator against the JAX package's on the same numpy-seeded inputs.

Tolerances: tap designs and slot centres bitwise (host float64, same
formulas); ``pfb_channelize`` in complex128 within 1e-10 of the JAX function
and of the mix -> lfilter -> [::K] oracle (float64 sums in another order);
``pfb_channelize_u8`` within 2e-6 of the JAX one over two chained blocks
(float32 sums of 16·K products of |x| < 1 values); the composed
channelizer's plain version within 2e-5 of ``composed_channelize_u8(
impl='xla')`` (both are float32 sums of 2·L = 5,312 products, in different
orders) and within 5e-5 of the float64 two-stage oracle, the JAX test's own
bound; ``estimate_psd`` within 1e-6 dB in float64, 1e-3 dB in float32.

The JAX package's Pallas route of the composed channelizer raises at trace
time for every geometry (a negative roll), so ``impl='xla'`` is how that
package computes it off the TPU, and what the port is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.ops import channelizer as jch
from rtsdr_tpu.ops import psd as jpsd
from rtsdr_tpu.pipeline.frontend import rf_lpf_taps as j_rf_lpf_taps
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops import channelizer as tch
from rtsdr_tpu_torch.ops import psd as tpsd
from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps

torch.set_num_threads(1)


@pytest.mark.parametrize("k,tpb", [(2, 16), (8, 12), (16, 16), (5, 7)])
def test_channelizer_taps_bitwise(k, tpb):
    a, b = jch.channelizer_taps(k, tpb), tch.channelizer_taps(k, tpb)
    assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)


@pytest.mark.parametrize("k,fs", [(4, 9.6e6), (16, 38.4e6), (5, 12.5e6)])
def test_channel_center_freqs_bitwise(k, fs):
    assert np.array_equal(jch.channel_center_freqs(k, fs),
                          tch.channel_center_freqs(k, fs))


@pytest.mark.parametrize("k,offsets", [
    (8, None), (4, [0.0, 150e3, 0.0, -75e3]), (16, None)])
def test_composed_rf_taps_bitwise(k, offsets):
    h = tch.channelizer_taps(k, 16)
    assert np.array_equal(rf_lpf_taps(MODE0), j_rf_lpf_taps(JMODE0))
    a = jch.composed_rf_taps(k, h, j_rf_lpf_taps(JMODE0), 10,
                             offsets_hz=offsets, fs_ch=2.4e6)
    b = tch.composed_rf_taps(k, h, rf_lpf_taps(MODE0), 10,
                             offsets_hz=offsets, fs_ch=2.4e6)
    assert b.shape == (k, 150 * k + 16 * k) and b.dtype == np.complex128
    assert np.array_equal(a, b)


def test_zero_states_equal():
    for k, taps in ((8, 96), (4, 61)):
        t = tch.channelizer_zi(k, taps, (2,), torch.complex128, "cpu")
        j = jch.channelizer_zi(k, taps, (2,), jnp.complex128)
        assert tuple(t.shape) == j.shape and not t.any()
        t = tch.channelizer_zi_u8(k, taps, (3,), "cpu")
        assert np.array_equal(t.numpy(),
                              np.asarray(jch.channelizer_zi_u8(k, taps, (3,))))
    t = tch.composed_zi_u8(2656, (2,), "cpu")
    assert np.array_equal(t.numpy(),
                          np.asarray(jch.composed_zi_u8(2656, (2,))))


@pytest.mark.parametrize("taps_per_branch", [12, None])
def test_pfb_channelize_f64_matches_jax_and_oracle(taps_per_branch):
    rng = np.random.default_rng(0)
    k = 8
    if taps_per_branch:
        h = np.asarray(tch.channelizer_taps(k, taps_per_branch))
    else:       # a prototype that does not fill its last branch
        h = np.asarray(tch.channelizer_taps(k, 12))[:91]
    n = k * 400
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    zi = tch.channelizer_zi(k, len(h), (), torch.complex128, "cpu")
    y, zi_end = tch.pfb_channelize(torch.as_tensor(x), h, zi, k)
    jy, jzi = jch.pfb_channelize(
        jnp.asarray(x), h, jch.channelizer_zi(k, len(h), dtype=jnp.complex128),
        k)
    assert y.dtype == torch.complex128 and tuple(y.shape) == (400, k)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-10)
    assert np.array_equal(zi_end.numpy(), np.asarray(jzi))
    for ch in (0, 1, 3, 7):
        z = x * np.exp(-2j * np.pi * ch * np.arange(n) / k)
        ref = signal.lfilter(h, 1.0, z)[::k]
        np.testing.assert_allclose(y.numpy()[:, ch], ref, rtol=0, atol=1e-10)

    # chained half blocks == one call (the overlap state is exact)
    y1, zi_a = tch.pfb_channelize(torch.as_tensor(x[:n // 2]), h, zi, k)
    y2, zi_b = tch.pfb_channelize(torch.as_tensor(x[n // 2:]), h, zi_a, k)
    assert torch.equal(torch.cat([y1, y2]), y)
    assert torch.equal(zi_b, zi_end)
    with pytest.raises(ValueError, match="does not divide"):
        tch.pfb_channelize(torch.as_tensor(x[:-1]), h, zi, k)


def test_pfb_channelize_u8_matches_jax_two_blocks(rng):
    k, c, m_out = 8, 2, 192
    h = tch.channelizer_taps(k, 16)
    n = m_out * k
    zi_t = tch.channelizer_zi_u8(k, len(h), (c,), "cpu")
    zi_j = jch.channelizer_zi_u8(k, len(h), (c,))
    zi_c = tch.channelizer_zi(k, len(h), (c,), torch.complex64, "cpu")
    for _ in range(2):      # the second block exercises the byte-tail carry
        raw = rng.integers(0, 256, (c, 2 * n), np.uint8)
        ours, zi_t = tch.pfb_channelize_u8(torch.as_tensor(raw), h, zi_t, k)
        theirs, zi_j = jch.pfb_channelize_u8(jnp.asarray(raw), h, zi_j, k)
        assert ours.dtype == torch.float32
        assert tuple(ours.shape) == (c, k, 2, m_out)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=2e-6)
        assert np.array_equal(zi_t.numpy(), np.asarray(zi_j))
        # and the complex phase-plane path of the port itself
        pairs = (raw.reshape(c, -1, 2).astype(np.float32) - 128.0) / 128.0
        x = torch.as_tensor(pairs[..., 0] + 1j * pairs[..., 1])
        y, zi_c = tch.pfb_channelize(x, h, zi_c, k)
        y = torch.movedim(y, -1, -2)
        np.testing.assert_allclose(
            ours.numpy(), torch.stack([y.real, y.imag], dim=-2).numpy(),
            rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="whole blocks"):
        tch.pfb_channelize_u8(torch.as_tensor(raw[:, :2 * k * 24]), h, zi_t, k)


def _two_stage_oracle(blocks, k, h, h_rf, decim):
    """channelize (float64) -> lfilter(h_rf) -> [::decim] per station over
    the concatenated stream, with an optional mix between the stages."""
    full = np.concatenate(blocks, axis=-1)
    c = full.shape[0]
    pairs = full.reshape(c, -1, 2)
    x = ((pairs[..., 0] - 128.0) + 1j * (pairs[..., 1] - 128.0)) / 128.0
    zi = tch.channelizer_zi(k, len(h), (c,), torch.complex128, "cpu")
    y, _ = tch.pfb_channelize(torch.as_tensor(x), h, zi, k)   # (c, M, K)
    return y.numpy()


@pytest.mark.parametrize("with_offsets", [False, True])
def test_composed_plain_matches_jax_xla_and_two_stage_oracle(with_offsets):
    rng = np.random.default_rng(7)
    k, c, decim, m_out = 8, 2, 10, 480
    p_if = m_out // decim
    fs_ch = MODE0.rf.fs
    h = tch.channelizer_taps(k, 16)
    h_rf = np.asarray(rf_lpf_taps(MODE0), np.float64)
    offs = None
    if with_offsets:
        offs = np.zeros(k)
        offs[1], offs[6] = 150e3, -225e3
    g = tch.composed_rf_taps(k, h, h_rf, decim, offsets_hz=offs, fs_ch=fs_ch)
    n = m_out * k
    blocks = [rng.integers(0, 256, (c, 2 * n), np.uint8) for _ in range(2)]

    y = _two_stage_oracle(blocks, k, h, h_rf, decim)
    ref = np.empty((c, k, 2, 2 * p_if))
    m_idx = np.arange(y.shape[1])
    p_idx = np.arange(2 * p_if)
    for ch in range(k):
        step = 0.0 if offs is None else -2.0 * np.pi * offs[ch] / fs_ch
        for ci in range(c):
            # mix at the channel rate, filter, decimate; the composed taps
            # leave the mix-out of the IF-rate samples to the caller
            z = signal.lfilter(h_rf, 1.0,
                               y[ci, :, ch] * np.exp(1j * step * m_idx))
            z = z[::decim] * np.exp(-1j * step * decim * p_idx)
            ref[ci, ch, 0], ref[ci, ch, 1] = z.real, z.imag

    zi_t = tch.composed_zi_u8(g.shape[1], (c,), "cpu")
    zi_j = jch.composed_zi_u8(g.shape[1], (c,))
    outs = []
    for blk in blocks:
        o, zi_t = tch.composed_channelize_u8(torch.as_tensor(blk), g, zi_t,
                                             decim)
        jo, zi_j = jch.composed_channelize_u8(jnp.asarray(blk), g, zi_j,
                                              decim, impl="xla")
        assert o.dtype == torch.float32 and tuple(o.shape) == (c, k, 2, p_if)
        assert zi_t.dtype == torch.uint8
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                                   atol=2e-5)
        assert np.array_equal(zi_t.numpy(), np.asarray(zi_j))
        outs.append(o.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1), ref, rtol=0,
                               atol=5e-5)


def test_composed_short_block_keeps_part_of_the_old_tail(rng):
    k, decim = 2, 10
    g = tch.composed_rf_taps(k, tch.channelizer_taps(k, 16),
                             rf_lpf_taps(MODE0), decim)
    n_tail = 2 * (g.shape[1] - 1)
    zi = torch.as_tensor(rng.integers(0, 256, (n_tail,), np.uint8))
    raw = torch.as_tensor(rng.integers(0, 256, (2 * decim * k * 3,), np.uint8))
    y, new = tch.composed_channelize_u8(raw, g, zi, decim)
    assert tuple(y.shape) == (k, 2, 3)
    assert torch.equal(new, torch.cat([zi, raw])[-n_tail:])


# ------------------------------------------------------ the two-stage route

WB8_OFFSETS = [200e3, -600e3, 800e3, -200e3, 400e3, 0.0, -800e3, 600e3]


def _factored(k, offsets, decim=10):
    return tch.composed_rf_factors(k, tch.channelizer_taps(k, 16),
                                   rf_lpf_taps(MODE0), decim,
                                   offsets_hz=offsets, fs_ch=MODE0.rf.fs)


def _composed_f64(blocks, g, decim):
    """sum_t g[t] X[d p - t] over the chained blocks, in float64 (the
    plain version's sum, ext = [zero tail | bytes])."""
    full = np.concatenate(blocks, axis=-1)
    x = torch.as_tensor((full[..., 0::2] - 128.0) + 1j * (
        full[..., 1::2] - 128.0)) / 128.0
    k, g_l = g.shape
    ext = torch.cat([torch.zeros((*x.shape[:-1], g_l - 1),
                                 dtype=x.dtype), x], -1)
    w = ext.unfold(-1, g_l, decim * k)             # (c, P, L): X[dp + t - L+1]
    return torch.einsum("cpt,kt->ckp", w, torch.as_tensor(g[:, ::-1].copy()))


def _two_stage_f64(blocks, h_ch, f, decim):
    """The slot bank then each station's RF FIR, in float64 torch:
    s_k[m] = sum_n h[n] W^{kn} X[K m - n], y_k[p] = sum_j f_k[j]
    s_k[decim p - j], the history zero."""
    full = np.concatenate(blocks, axis=-1)
    x = torch.as_tensor((full[..., 0::2] - 128.0) + 1j * (
        full[..., 1::2] - 128.0)) / 128.0
    k, l_rf = f.shape
    l_ch = len(h_ch)
    hist = k * (l_rf - 1) + l_ch - 1
    ext = torch.cat([torch.zeros((*x.shape[:-1], hist), dtype=x.dtype), x],
                    -1)
    n_idx = np.arange(l_ch)
    hk = h_ch[None, :] * np.exp(2j * np.pi * np.arange(k)[:, None]
                                * n_idx[None, :] / k)
    # s at m = -(l_rf - 1) ... : the window ends at X[K m]
    s = torch.einsum("cmn,kn->ckm", ext.unfold(-1, l_ch, k),
                     torch.as_tensor(hk[:, ::-1].copy()))
    sw = s.unfold(-1, l_rf, decim)                  # (c, K, P, l_rf)
    return torch.einsum("ckpj,kj->ckp", sw, torch.as_tensor(
        f[:, ::-1].copy()))


@pytest.mark.parametrize("k,offsets", [(8, WB8_OFFSETS), (16, "all")])
def test_two_stage_oracle_equals_the_composed_sum(k, offsets):
    """The regrouping is exact: the slot bank then the stations' RF FIRs
    (float64) equal g's one FIR (float64) within 1e-12 max sum|g| over two
    chained blocks, and the plain version (float32) within the kernel's
    tolerance, its byte tail carried."""
    if offsets == "all":
        offsets = np.linspace(-90e3, 90e3, k) + 1e3
    g, (h_ch, f) = _factored(k, offsets)
    rng = np.random.default_rng(k)
    c, p_if, decim = 2, 24, 10
    blocks = [rng.integers(0, 256, (c, 2 * decim * k * p_if), np.uint8)
              for _ in range(2)]
    two = _two_stage_f64(blocks, h_ch, f, decim).numpy()
    one = _composed_f64(blocks, g, decim).numpy()
    g_l1 = float(np.abs(g).sum(axis=1).max())
    assert two.shape == (c, k, 2 * p_if)
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-12 * g_l1)
    zi = tch.composed_zi_u8(g.shape[1], (c,), "cpu")
    outs = []
    for blk in blocks:
        y, zi = tch.composed_channelize_u8(torch.as_tensor(blk), g, zi, decim,
                                           (h_ch, f))
        outs.append(y.numpy())
    y = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(y[:, :, 0] + 1j * y[:, :, 1], two, rtol=0,
                               atol=8e-6 * g_l1)
    assert np.array_equal(zi.numpy(), blocks[1][:, -2 * (g.shape[1] - 1):])


@pytest.mark.parametrize("k,offsets,route", [
    (8, WB8_OFFSETS, "two_stage"),            # 19,904 FLOP against 79,744
    (8, None, "shared"),                      # 5,824 against 19,904
    (16, "all", "two_stage"),                 # 50,048 against 339,968
    (16, "one", "mixed"),                     # 33,792 against 50,048
])
def test_plan_route_follows_the_work(k, offsets, route):
    if offsets == "all":
        offsets = np.linspace(-90e3, 90e3, k) + 1e3
    elif offsets == "one":
        offsets = np.zeros(k)
        offsets[k // 2] = 150e3
    g, factors = _factored(k, offsets)
    plan = tch.composed_plan(g, 10, factors)
    bare = tch.composed_plan(g, 10)             # no factors: today's roles
    assert not bare.two_stage and len(bare.shared) + len(bare.own) == k
    if route == "two_stage":
        assert plan.two_stage and plan.shared == plan.own == ()
        assert plan.stage_a.shape == (16, k)
        assert plan.stage_b.shape == (10, 16, k, 2)
        # tap 16 a + r of the prototype / 128; RF tap 10 a + b of station k
        np.testing.assert_array_equal(
            plan.stage_a[3, 1], np.float32(factors[0][k * 3 + 1] / 128.0))
        assert plan.stage_b[2, 5, 1, 1] == np.float32(factors[1][1, 52].imag)
    else:
        assert not plan.two_stage
        assert (plan.shared, plan.own) == (bare.shared, bare.own)
        assert len(plan.own) == (0 if route == "shared" else 1)


def test_plan_factors_must_compose_to_g():
    g, (h_ch, f) = _factored(8, WB8_OFFSETS)
    bad = f.copy()
    bad[3, 70] += 1e-9 * np.abs(f).max()
    with pytest.raises(ValueError, match="do not compose"):
        tch.composed_plan(g, 10, (h_ch, bad))
    with pytest.raises(ValueError, match="factors"):
        tch.composed_plan(g, 10, (h_ch[:-8], f))
    plan = tch.composed_plan(g, 10, (h_ch, f))
    assert plan.two_stage and tch.composed_plan(g, 10, (h_ch, f)) is plan


class OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on a CUDA device."""

    is_cuda = property(lambda self: True)


def test_composed_on_a_device_tensor_launches_or_raises(monkeypatch, rng):
    """Dispatch is by the tensor's device alone: a CUDA tensor reaches the
    kernel's launch (one count of ``channelizer.composed``), and what the
    kernel cannot take raises before it; nothing computes the plain version
    for a device tensor."""
    seen = []
    monkeypatch.setattr(
        _cuda, "launch",
        lambda entry, count_as, *a: seen.append((entry, count_as, a[9:])))
    monkeypatch.setattr(tch, "_sm_count", lambda dev: 132)   # an H100's
    monkeypatch.setattr(
        tch, "composed_channelize_u8_ref",
        lambda *a, **k: pytest.fail("the plain version ran for a device "
                                    "tensor"))
    k, decim = 4, 10
    g = tch.composed_rf_taps(k, tch.channelizer_taps(k, 16),
                             rf_lpf_taps(MODE0), decim)
    taps = g.shape[1]
    raw = torch.zeros((2, 2 * decim * k * 32), dtype=torch.uint8
                      ).as_subclass(OnCard)
    zi = tch.composed_zi_u8(taps, (2,), "cpu")
    y, new_zi = tch.composed_channelize_u8(raw, g, zi, decim)
    plan = tch.composed_plan(g, decim)
    geo = tch.composed_geometry(plan, 2, 32, 132)
    ((entry, count_as, ints),) = seen
    assert (entry, count_as) == ("rtsdr_channelize_composed",
                                 "channelizer.composed")
    assert ints[:7] == (2, decim * k * 32, k, taps, decim * k, plan.a_sp, 32)
    assert ints[7:] == (geo.tile, geo.n_tiles, geo.nb, geo.pitch, k, 0,
                        geo.own_lanes, geo.n_og, geo.ns_sh, geo.ns_own,
                        geo.g_sh, geo.g_own, geo.plane_elems, geo.smem)
    assert tuple(y.shape) == (2, k, 2, 32) and y.dtype == torch.float32
    assert tuple(new_zi.shape) == (2, 2 * (taps - 1))
    proto, tw, sh, own_taps, own = tch._plan_on(g, plan, torch.device("cpu"))
    assert own_taps is None and own is None          # no own-taps station
    assert proto.dtype == torch.float32 and proto.is_contiguous()
    assert tuple(proto.shape) == (decim * k, plan.a_sp | 1)
    assert sh.dtype == torch.int32 and sh.tolist() == list(range(k))
    assert tuple(tw.shape) == (k, 2)
    assert tch._plan_on(g, plan, torch.device("cpu"))[0] is proto  # once
    for bad_raw, bad_zi, err in (
            (raw.to(torch.float32).as_subclass(OnCard), zi, TypeError),
            (raw[:, :-2], zi, ValueError),
            (raw, zi[:, :-2], ValueError)):
        with pytest.raises(err):
            tch.composed_channelize_u8(bad_raw, g, bad_zi, decim)
    assert len(seen) == 1


def test_two_stage_on_a_device_tensor_launches(monkeypatch, rng):
    """With factors that make it the least work, a CUDA tensor reaches the
    two-stage entry (one count of ``channelizer.composed_two_stage``) with
    the plan's arrays, the residual NCO's phase and ramp (NULL without
    ``mix``) and the geometry; without factors, the composed one."""
    seen = []
    monkeypatch.setattr(
        _cuda, "launch",
        lambda entry, count_as, *a: seen.append((entry, count_as, a)))
    monkeypatch.setattr(tch, "_sm_count", lambda dev: 132)
    k, decim, p_if = 8, 10, 64
    g, factors = _factored(k, WB8_OFFSETS)
    taps = g.shape[1]
    raw = torch.zeros((3, 2 * decim * k * p_if), dtype=torch.uint8
                      ).as_subclass(OnCard)
    zi = tch.composed_zi_u8(taps, (3,), "cpu")
    y, new_zi = tch.composed_channelize_u8(raw, g, zi, decim, factors)
    plan = tch.composed_plan(g, decim, factors)
    geo = tch.two_stage_geometry(plan, 3, p_if, 132)
    ((entry, count_as, args),) = seen
    assert (entry, count_as) == ("rtsdr_channelize_two_stage",
                                 "channelizer.composed_two_stage")
    assert args[6:8] == (None, None)     # no residual NCO: NULL pointers
    assert args[10:] == (3, decim * k * p_if, k, k, taps, decim, p_if,
                         geo.tile, geo.n_tiles, geo.ns, geo.pitch_a,
                         geo.a_elems, geo.bp, geo.kp, geo.smem)
    assert tuple(y.shape) == (3, k, 2, p_if)
    assert tuple(new_zi.shape) == (3, 2 * (taps - 1))
    ha, fb, tw, slots = tch._plan_on(g, plan, torch.device("cpu"))
    assert tuple(ha.shape) == (16, k) and tuple(fb.shape) == (10, 16, k, 2)
    assert tuple(tw.shape) == (k, 2) and fb.dtype == torch.float32
    # one station a slot: station k in slot k
    assert slots.dtype == torch.int32 and slots.tolist() == list(range(k))
    # with the residual NCO: its phase and ramp, for the epilogue
    mix = (torch.zeros(k), torch.zeros((k, p_if)))
    tch.composed_channelize_u8(raw, g, zi, decim, factors, mix=mix)
    assert seen[-1][2][6:8] == tuple(t.data_ptr() for t in mix)
    tch.composed_channelize_u8(raw, g, zi, decim)
    assert seen[-1][:2] == ("rtsdr_channelize_composed",
                            "channelizer.composed")


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_estimate_psd_matches_jax(rng, prec):
    nd = np.float32 if prec == "f32" else np.float64
    x = rng.standard_normal((3, 5000)).astype(nd)
    x += np.sin(2 * np.pi * 19e3 * np.arange(5000) / 240e3).astype(nd)
    tf, tp = tpsd.estimate_psd(torch.as_tensor(x), 1024, 240e3)
    jf, jp = jpsd.estimate_psd(jnp.asarray(x), 1024, 240e3)
    assert np.array_equal(tf, jf) and np.array_equal(
        tpsd.psd_freqs(512, 250e3), jpsd.psd_freqs(512, 250e3))
    assert tuple(tp.shape) == (3, 512) and tp.numpy().dtype == nd
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6 if prec == "f64" else 1e-3)
