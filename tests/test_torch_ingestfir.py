"""``rtsdr_tpu_torch.ops.ingestfir`` on CPU tensors (the plain versions of
the fused ingest kernel) against the JAX functions on their float32 route
and on the interpret-mode Pallas kernel.

Float32 route: I/Q 3e-6, fm 5e-6, audio 2e-6 * max|ref|, carried state 1e-6
(151-term float32 sums in two orders; atan2 of two libraries).  Pallas
route, at that kernel's own test geometry (C = 32, n = 2*10*128*5*4) and
tolerances (tests/test_ingestfir.py): the two-level int8 taps and bf16
audio windows are the TPU's arithmetic, not the function's.

Inputs whose fm is compared are a constant-envelope FM signal plus noise,
as a receiver sees: on near-zero I/Q (pure random bytes after the low-pass)
the discriminator's angle is ill-conditioned and any two float32 routes
part by far more than their FIR rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops import ingestfir as jing
from rtsdr_tpu_torch.ops import ingestfir as ting

torch.set_num_threads(1)

RF_H = np.asarray(coeffs.lowpass_taps(2.4e6, 100e3, 151), np.float64)
MONO_H = np.asarray(coeffs.lowpass_taps(240e3, 16e3, 151), np.float64)
DECIM, DOWN = 10, 5


def _fm_bytes(rng, c, n_pairs, noise=6):
    """(c, 2*n_pairs) uint8: FM-modulated tones, amplitude 100, + noise."""
    t = np.arange(n_pairs) / 2.4e6
    rows = []
    for k in range(c):
        m = (0.5 * np.sin(2 * np.pi * (900 + 170 * k) * t + k)
             + 0.1 * np.cos(2 * np.pi * 19e3 * t + 0.3 * k))
        ph = 2 * np.pi * 75e3 * np.cumsum(m) / 2.4e6 + 0.7 * k
        iq = np.empty(2 * n_pairs)
        iq[0::2], iq[1::2] = np.cos(ph), np.sin(ph)
        rows.append(iq * 100.0 + 128.0)
    raw = np.stack(rows) + rng.integers(-noise, noise + 1, (c, 2 * n_pairs))
    return np.clip(np.round(raw), 0, 255).astype(np.uint8)


def _state(rng, c):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(zi_i=f(c, 150), zi_q=f(c, 150), prev_i=f(c) + 0.7,
                prev_q=f(c), azi=f(c, 150))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _cmp(t, j, atol):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0, atol=atol)


@pytest.mark.parametrize("c,n_pairs", [(3, 2560), (1, 1500), (32, 1280)])
def test_decimate_matches_f32_route(rng, c, n_pairs):
    raw = rng.integers(0, 256, (c, 2 * n_pairs), dtype=np.uint8)
    s = _state(rng, c)
    t = ting.ingest_fir_decimate(_t(raw), RF_H, _t(s["zi_i"]), _t(s["zi_q"]),
                                 DECIM)
    j = jing.ingest_fir_decimate(jnp.asarray(raw), RF_H,
                                 jnp.asarray(s["zi_i"]),
                                 jnp.asarray(s["zi_q"]), DECIM, impl="f32")
    for a, b, tol in zip(t, j, (3e-6, 3e-6, 1e-6, 1e-6)):
        _cmp(a, b, tol)


@pytest.mark.parametrize("c,n_pairs", [(3, 2560), (1, 1500)])
def test_demod_matches_split_route(rng, c, n_pairs):
    raw = _fm_bytes(rng, c, n_pairs)
    s = _state(rng, c)
    args = ("zi_i", "zi_q", "prev_i", "prev_q")
    t = ting.ingest_fir_demod(_t(raw), RF_H, *(_t(s[k]) for k in args), DECIM)
    j = jing.ingest_fir_demod(jnp.asarray(raw), RF_H,
                              *(jnp.asarray(s[k]) for k in args), DECIM,
                              impl="split")
    for a, b, tol in zip(t, j, (5e-6, 1e-6, 1e-6, 1e-6, 1e-6)):
        _cmp(a, b, tol)


@pytest.mark.parametrize("emit_fm", [True, False])
def test_demod_audio_matches_unfused_route_two_blocks(rng, emit_fm):
    c, n_pairs = 3, 2500
    raw = _fm_bytes(rng, c, 2 * n_pairs)
    s = _state(rng, c)
    keys = ("zi_i", "zi_q", "prev_i", "prev_q", "azi")
    ts = [_t(s[k]) for k in keys]
    js = [jnp.asarray(s[k]) for k in keys]
    for b in range(2):
        blk = raw[:, b * 2 * n_pairs:(b + 1) * 2 * n_pairs]
        t = ting.ingest_fir_demod_audio(_t(blk), RF_H, *ts[:4], DECIM, MONO_H,
                                        ts[4], DOWN, emit_fm=emit_fm)
        j = jing.ingest_fir_demod_audio(jnp.asarray(blk), RF_H, *js[:4],
                                        DECIM, MONO_H, js[4], DOWN,
                                        emit_fm=emit_fm, impl="xla")
        assert len(t) == 7
        if emit_fm:
            _cmp(t[0], j[0], 5e-6)
        else:
            assert t[0] is None     # JAX's unfused route always returns fm
        _cmp(t[1], j[1], 2e-6 * float(np.max(np.abs(np.asarray(j[1])))))
        for a, bb in zip(t[2:6], j[2:6]):
            _cmp(a, bb, 1e-6)
        _cmp(t[6], j[6], 5e-6)      # the carried fm tail
        ts, js = list(t[2:]), list(j[2:])


@pytest.mark.parametrize("emit_fm", [True, False])
def test_demod_audio_matches_pallas_interpret(rng, emit_fm):
    c = 32
    n = 2 * DECIM * 128 * DOWN * 4          # 4 output tiles of 640
    # the carried RF tail continues the same signal (a random tail would
    # make the first IF samples near-zero, where the angle is
    # ill-conditioned and the int8 taps' 4e-5 shows as 1e-2)
    long = _fm_bytes(rng, c, n // 2 + 150)
    raw = np.ascontiguousarray(long[:, 300:])
    s = _state(rng, c)
    tail = (long[:, :300].astype(np.float32) - 128.0) / 128.0
    s["zi_i"], s["zi_q"] = tail[:, 0::2].copy(), tail[:, 1::2].copy()
    keys = ("zi_i", "zi_q", "prev_i", "prev_q")
    t = ting.ingest_fir_demod_audio(
        _t(raw), RF_H, *(_t(s[k]) for k in keys), DECIM, MONO_H,
        _t(s["azi"]), DOWN, emit_fm=emit_fm)
    j = jing.ingest_fir_demod_audio(
        jnp.asarray(raw), RF_H, *(jnp.asarray(s[k]) for k in keys), DECIM,
        MONO_H, jnp.asarray(s["azi"]), DOWN, emit_fm=emit_fm, impl="pallas")
    if emit_fm:
        # two-level int8 taps (~15 bits) + polynomial atan2, on |IQ| ~ 0.78
        _cmp(t[0], j[0], 2e-4)
    else:
        assert t[0] is None and j[0] is None
    _cmp(t[1], j[1], 2e-2 * float(np.max(np.abs(np.asarray(j[1])))) + 1e-6)
    _cmp(t[2], j[2], 1e-6)
    _cmp(t[3], j[3], 1e-6)
    _cmp(t[4], j[4], 1e-4)
    _cmp(t[5], j[5], 1e-4)
    _cmp(t[6], j[6], 2e-4)


def test_decimate_matches_pallas_interpret(rng):
    c = 32
    n = 2 * DECIM * 128 * 4
    raw = rng.integers(0, 256, (c, n), dtype=np.uint8)
    s = _state(rng, c)
    t = ting.ingest_fir_decimate(_t(raw), RF_H, _t(s["zi_i"]), _t(s["zi_q"]),
                                 DECIM)
    j = jing.ingest_fir_decimate(jnp.asarray(raw), RF_H,
                                 jnp.asarray(s["zi_i"]),
                                 jnp.asarray(s["zi_q"]), DECIM, impl="pallas")
    # tests/test_ingestfir.py holds the s8 routes to 1e-4 of the f32 one
    for a, b, tol in zip(t, j, (1e-4, 1e-4, 1e-6, 1e-6)):
        _cmp(a, b, tol)


BANK_H = [np.asarray(coeffs.bandpass_taps(240e3, lo, hi, 151), np.float64)
          for lo, hi in ((18.5e3, 19.5e3), (22e3, 54e3), (54e3, 60e3))]


@pytest.mark.parametrize("emit_fm", [True, False])
@pytest.mark.parametrize("n_bank", [3, 1])
def test_bank_stage_matches_jax_two_blocks(rng, emit_fm, n_bank):
    """``bank_h``: the F band-passes over the same fm, against the JAX
    function's CPU route, over a block seam with the carried ``bank_zi``
    (= the carried fm tail, as the receiver feeds it).  fm 5e-6 rad, bank
    outputs 2e-6 * max|ref| plus what the fm difference itself can cause."""
    c, n_pairs = 3, 2500
    raw = _fm_bytes(rng, c, 2 * n_pairs)
    s = _state(rng, c)
    keys = ("zi_i", "zi_q", "prev_i", "prev_q", "azi")
    ts = [_t(s[k]) for k in keys]
    js = [jnp.asarray(s[k]) for k in keys]
    bzi = (rng.standard_normal((c, 150)) * 0.1).astype(np.float32)
    t_bzi, j_bzi = _t(bzi), jnp.asarray(bzi)
    hs = BANK_H[:n_bank]
    for b in range(2):
        blk = raw[:, b * 2 * n_pairs:(b + 1) * 2 * n_pairs]
        t = ting.ingest_fir_demod_audio(
            _t(blk), RF_H, *ts[:4], DECIM, MONO_H, ts[4], DOWN,
            emit_fm=emit_fm, bank_h=hs, bank_zi=t_bzi)
        j = jing.ingest_fir_demod_audio(
            jnp.asarray(blk), RF_H, *js[:4], DECIM, MONO_H, js[4], DOWN,
            emit_fm=emit_fm, bank_h=hs, bank_zi=j_bzi)
        assert len(t) == len(j) == 8
        assert isinstance(t[7], tuple) and len(t[7]) == n_bank
        if emit_fm:
            _cmp(t[0], j[0], 5e-6)
        else:
            assert t[0] is None
        _cmp(t[1], j[1], 2e-6 * float(np.max(np.abs(np.asarray(j[1])))))
        for a, bb in zip(t[2:6], j[2:6]):
            _cmp(a, bb, 1e-6)
        _cmp(t[6], j[6], 5e-6)
        # the two packages' fm differ (two atan2 libraries, <= 5e-6 rad);
        # a filter passes that on scaled by at most sum|h|, which for the
        # narrow pilot band-pass is not small beside its own output
        t_fm = ting.ingest_fir_demod_audio(
            _t(blk), RF_H, *ts[:4], DECIM, MONO_H, ts[4], DOWN)[0]
        dfm = float(np.max(np.abs(t_fm.numpy() - np.asarray(j[0]))))
        assert dfm <= 5e-6
        for a, bb, h in zip(t[7], j[7], hs):
            assert a.shape == (c, n_pairs // DECIM)
            _cmp(a, bb, 2e-6 * float(np.max(np.abs(np.asarray(bb))))
                 + dfm * float(np.sum(np.abs(h))))
        ts, js = list(t[2:7]), list(j[2:7])
        t_bzi, j_bzi = t[6], j[6]          # the next bank_zi is the fm tail


def test_bank_stage_equals_fir_block_bank(rng):
    """The stage is ``fir_block_bank(fm, bank_h, bank_zi)`` by definition."""
    from rtsdr_tpu_torch.ops.fir import fir_block_bank

    raw = _fm_bytes(rng, 2, 2000)
    s = _state(rng, 2)
    bzi = _t((rng.standard_normal((2, 150)) * 0.1).astype(np.float32))
    out = ting.ingest_fir_demod_audio(
        _t(raw), RF_H, *(_t(s[k]) for k in ("zi_i", "zi_q", "prev_i",
                                            "prev_q")),
        DECIM, MONO_H, _t(s["azi"]), DOWN, bank_h=BANK_H, bank_zi=bzi)
    ys, _ = fir_block_bank(out[0], BANK_H, bzi)
    for a, b in zip(out[7], ys):
        assert torch.equal(a, b)


def test_bank_epilogue_names_the_rds_slice():
    """The bank stage's arguments go together, and the kernel route refuses
    what the kernel cannot take (more than 3 filters, unequal or longer
    taps than the audio filter's) before any launch."""
    from rtsdr_tpu_torch.ops import _cuda

    raw = torch.zeros(1, 200, dtype=torch.uint8)
    z = torch.zeros(1, 150)
    args = (raw, RF_H, z, z, torch.ones(1), torch.zeros(1), DECIM, MONO_H,
            z, DOWN)
    with pytest.raises(ValueError, match="go together"):
        ting.ingest_fir_demod_audio(*args, bank_h=[MONO_H])
    with pytest.raises(ValueError, match="go together"):
        ting.ingest_fir_demod_audio(*args, bank_zi=z)

    class OnCard(torch.Tensor):
        is_cuda = property(lambda self: True)

    card_args = (raw.as_subclass(OnCard),) + args[1:]
    launched = []
    orig = _cuda.launch
    _cuda.launch = lambda entry, count_as, *a: launched.append(entry)
    try:
        for bad in ([MONO_H] * 4, [MONO_H, MONO_H[:-2]],
                    [np.zeros(153)]):
            with pytest.raises(ValueError, match="bank_h takes"):
                ting.ingest_fir_demod_audio(
                    *card_args, bank_h=bad,
                    bank_zi=torch.zeros(1, len(bad[0]) - 1))
        assert launched == []
        ting.ingest_fir_demod_audio(*card_args, bank_h=BANK_H, bank_zi=z)
        assert launched == ["rtsdr_ingest_fm_audio_bank"]
    finally:
        _cuda.launch = orig


def test_cuda_wrappers_never_run_plain_on_a_cuda_tensor():
    """A meta-device stand-in is not a CPU tensor either; the dispatch is by
    ``is_cuda`` alone, so what is not on the CPU reaches the kernel path
    (which needs the card) and nothing else reaches the plain version."""
    import inspect

    for fn in (ting.ingest_fir_decimate, ting.ingest_fir_demod,
               ting.ingest_fir_demod_audio):
        src = inspect.getsource(fn)
        assert "if not raw_u8.is_cuda:" in src
        assert "try:" not in src and "except" not in src
