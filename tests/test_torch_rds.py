"""``rtsdr_tpu_torch.pipeline.rds`` (CPU, plain versions) against
``rtsdr_tpu.pipeline.rds.make_rds`` on the same fm blocks of an RDS-bearing
station, three blocks, with the state carried from the JAX chain into the
port after block 1.

Both chains start from the same small non-zero band-pass states: from the
all-zero state the squared band-pass feeds the carrier loop a few samples
of exactly 0, where the reference's scan-form detector (atan2(-0, -0)) and
its kernels part by design (ROADMAP Queue C; the port follows the kernels).

rrc within 1e-4 * max|ref|: two PLL-driven mixers (the loops of the two
packages round one angle differently: ~1e-5 on the NCO) before 158- and
151-term float32 sums.  FIR states 1e-5, the PLL's leaves 1e-3 (angles mod
4 pi), as tests/test_torch_receiver.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsdr_tpu.config import MODE0 as JMODE0
from rtsdr_tpu.ops import coeffs as jcoeffs
from rtsdr_tpu.pipeline import rds as jrds
from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.ops import coeffs as tcoeffs
from rtsdr_tpu_torch.ops.cuda_fir import fir_block_pre
from rtsdr_tpu_torch.ops.fir import fir_block
from rtsdr_tpu_torch.ops.pll import pll
from rtsdr_tpu_torch.pipeline import rds as trds
from rtsdr_tpu_torch.pipeline.frontend import frontend_init, make_frontend
from rtsdr_tpu_torch.utils import signals

torch.set_num_threads(1)

N_BLOCKS = 3
_FOUR_PI = 4 * np.pi


@pytest.fixture(scope="module")
def fm_blocks():
    """(N_BLOCKS, 2, if_len) float32 fm of two RDS-bearing stations, made by
    the port's front end (the input of both RDS chains)."""
    rng = np.random.default_rng(0x5757)
    rows = []
    for k in range(2):
        wave = signals.rds_baseband(signals.encode_rds_blocks(
            rng.integers(0, 2, (40, 16))))
        rows.append(signals.fm_multiplex_iq(
            N_BLOCKS * MODE0.iq_len, rds_wave=wave, mono_hz=900.0 + 300 * k,
            pilot_phase=0.4 * k).reshape(N_BLOCKS, MODE0.block_size))
    raw = np.stack(rows, 1)
    fe = make_frontend(MODE0, torch.float32, device="cpu")
    state = frontend_init(MODE0, (2,), torch.float32, "cpu")
    out = []
    for b in range(N_BLOCKS):
        fm, state = fe(state, torch.as_tensor(raw[b]))
        out.append(fm.numpy())
    return np.stack(out)


def _state_pairs(t_state, j_state):
    for name in ("extract_zi", "squared_zi", "resamp_zi", "rrc_zi"):
        yield name, getattr(t_state, name).numpy(), \
            np.asarray(getattr(j_state, name)), False
    for name in t_state.pll._fields:
        yield f"pll.{name}", getattr(t_state.pll, name).numpy(), \
            np.asarray(getattr(j_state.pll, name)), True


def _assert_states_close(t_state, j_state):
    for name, t, j, is_pll in _state_pairs(t_state, j_state):
        assert t.shape == j.shape and t.dtype == j.dtype, name
        d = np.abs(t - j)
        if name.endswith(("phase_est", "theta")):
            d = np.minimum(d % _FOUR_PI, _FOUR_PI - d % _FOUR_PI)
        scale = max(1.0, float(np.max(np.abs(j))))
        assert float(d.max()) <= (1e-3 if is_pll else 1e-5 * scale), name


def _state_to_torch(j_state):
    to = lambda a: torch.as_tensor(np.array(a))
    return trds.RDSState(
        extract_zi=to(j_state.extract_zi), squared_zi=to(j_state.squared_zi),
        pll=type(trds.rds_init(MODE0, (), device="cpu").pll)(
            *(to(v) for v in j_state.pll)),
        resamp_zi=to(j_state.resamp_zi), rrc_zi=to(j_state.rrc_zi))


def test_init_states_equal():
    t = trds.rds_init(MODE0, (2,), torch.float32, "cpu")
    j = jrds.rds_init(JMODE0, (2,), jnp.float32)
    for name, a, b, _ in _state_pairs(t, j):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert t.resamp_zi.shape == (2, 2, 3000) and t.rrc_zi.shape == (2, 2, 150)


@pytest.mark.parametrize("branch", ["standalone", "hooks"])
def test_make_rds_matches_jax_three_blocks(fm_blocks, branch):
    """``standalone``: the chain's own extract band-pass, squared band-pass
    and PLL call (what ``enable_stereo=False`` runs).  ``hooks``: extract,
    the carrier NCO and the fm tail handed in precomputed, as the receiver's
    fused route hands them."""
    t_rds = trds.make_rds(MODE0)
    j_rds = jrds.make_rds(JMODE0)
    t_state = trds.rds_init(MODE0, (2,), torch.float32, "cpu")
    j_state = jrds.rds_init(JMODE0, (2,), jnp.float32)
    seed = np.random.default_rng(3)
    ezi = (seed.standard_normal((2, 150)) * 1e-2).astype(np.float32)
    szi = (seed.standard_normal((2, 150)) * 1e-4).astype(np.float32)
    t_state = t_state._replace(extract_zi=torch.as_tensor(ezi),
                               squared_zi=torch.as_tensor(szi))
    j_state = j_state._replace(extract_zi=jnp.asarray(ezi),
                               squared_zi=jnp.asarray(szi))
    r, if_fs = MODE0.rds, MODE0.rf.if_fs
    ext_h = tcoeffs.bandpass_taps(if_fs, r.extract_lo, r.extract_hi, r.taps)
    sq_h = tcoeffs.bandpass_taps(if_fs, r.squared_lo, r.squared_hi, r.taps)
    peak = 0.0
    for b in range(N_BLOCKS):
        fm = torch.as_tensor(fm_blocks[b])
        if branch == "standalone":
            (ti, tq), t_new = t_rds(t_state, fm)
        else:
            extract, _ = fir_block(fm, ext_h, t_state.extract_zi)
            pre, sq_zi = fir_block_pre(extract, sq_h, t_state.squared_zi,
                                       "square")
            p = r.pll
            ni, nq, pst = pll(pre, t_state.pll, freq=p.freq, fs=if_fs,
                              nco_scale=p.nco_scale,
                              phase_adjust=p.phase_adjust,
                              norm_bandwidth=p.norm_bandwidth)
            tail = fm[..., -150:] if b % 2 else None   # both tail routes
            (ti, tq), t_new = t_rds(
                t_state, None if tail is not None else fm, extract=extract,
                nco_pre=(ni, nq, pst, sq_zi), fm_tail=tail)
        (ji, jq), j_state = j_rds(j_state, jnp.asarray(fm_blocks[b]))
        t_state = t_new
        for t, j in ((ti, ji), (tq, jq)):
            j = np.asarray(j)
            assert t.shape == j.shape == (2, MODE0.rds_len)
            assert t.numpy().dtype == j.dtype
            peak = max(peak, float(np.max(np.abs(j))))
            np.testing.assert_allclose(
                t.numpy(), j, rtol=0, atol=1e-4 * float(np.max(np.abs(j))))
        _assert_states_close(t_state, j_state)
        if b == 0:
            # state carried across: the port continues from the JAX state
            t_state = _state_to_torch(jax.tree.map(np.asarray, j_state))
    assert peak > 0.05       # a real RDS baseband, not the noise floor


def test_rds_taps_equal():
    r = JMODE0.rds
    for f, args in (("bandpass_taps", (240e3, r.extract_lo, r.extract_hi,
                                       r.taps)),
                    ("bandpass_taps", (240e3, r.squared_lo, r.squared_hi,
                                       r.taps)),
                    ("rrc_taps", (r.rrc_fs, r.rrc_taps, r.rrc_beta,
                                  r.symbol_rate))):
        assert np.array_equal(getattr(jcoeffs, f)(*args),
                              getattr(tcoeffs, f)(*args))
