"""Where the port's work runs is decided by the tensor's device alone.

Every function that has a CUDA kernel takes the kernel route for a CUDA
tensor — and the kernel route raises for what the kernel cannot take (any
dtype but float32, an empty block) instead of computing the plain version
on the card — and the plain version only for a CPU tensor.

No card is needed: a CPU tensor of a subclass that reports ``is_cuda`` stands
in for a device tensor, and ``_cuda.launch`` is replaced by a recorder, so
"reached the launch" and "raised before it" are both visible.
"""

import numpy as np
import pytest
import torch

from rtsdr_tpu_torch.config import MODE0
from rtsdr_tpu_torch.device import require_kernel_dtype
from rtsdr_tpu_torch.ops import (
    _cuda,
    coeffs,
    cuda_fir,
    cuda_resample,
    fir,
    ingestfir,
)
from rtsdr_tpu_torch.ops import pll as tpll
from rtsdr_tpu_torch.pipeline.frontend import make_frontend
from rtsdr_tpu_torch.pipeline.receiver import Receiver

torch.set_num_threads(1)

H = coeffs.lowpass_taps(240e3, 16e3, 31)
PLL_KW = dict(freq=19e3, fs=240e3, nco_scale=2.0)


class OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on a CUDA device."""

    is_cuda = property(lambda self: True)


def on_card(shape, dtype):
    return torch.zeros(shape, dtype=dtype).as_subclass(OnCard)


@pytest.fixture
def launches(monkeypatch):
    seen = []
    monkeypatch.setattr(
        _cuda, "launch", lambda entry, count_as, *a: seen.append(entry))
    return seen


def _fir_calls(x, zi):
    return {
        "fir_block": lambda: fir.fir_block(x, H, zi),
        "fir_block_bank": lambda: fir.fir_block_bank(x, [H, H], zi),
        "fir_block_multi": lambda: fir.fir_block_multi(x, [H, H], zi),
        "fir_decimate": lambda: fir.fir_decimate(x, H, zi, 5),
        "fir_resample": lambda: fir.fir_resample(x, H, zi, 1, 5),
        "fir_bank": lambda: cuda_fir.fir_bank(x, [H]),
        "fir_bank_carried": lambda: cuda_fir.fir_bank_carried(x, [H], zi),
        "fir_block_pre": lambda: cuda_fir.fir_block_pre(x, H, zi, "square"),
    }


FIR_NAMES = sorted(_fir_calls(None, None))


@pytest.mark.parametrize("name", FIR_NAMES)
def test_fir_f32_device_tensor_reaches_the_kernel(launches, name):
    x, zi = on_card((2, 40), torch.float32), on_card((2, 30), torch.float32)
    _fir_calls(x, zi)[name]()
    assert launches == ["rtsdr_fir_bank"]


@pytest.mark.parametrize("name", FIR_NAMES)
def test_fir_f64_device_tensor_raises(launches, name):
    x, zi = on_card((2, 40), torch.float64), on_card((2, 30), torch.float64)
    with pytest.raises(TypeError, match="float32"):
        _fir_calls(x, zi)[name]()
    assert launches == []


@pytest.mark.parametrize("name", FIR_NAMES)
def test_fir_empty_device_tensor_raises(launches, name):
    x, zi = on_card((2, 0), torch.float32), on_card((2, 30), torch.float32)
    with pytest.raises(ValueError, match="empty"):
        _fir_calls(x, zi)[name]()
    assert launches == []


@pytest.mark.parametrize("name", FIR_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fir_cpu_tensor_runs_the_plain_version(launches, name, dtype):
    x, zi = torch.ones((2, 40), dtype=dtype), torch.zeros((2, 30), dtype=dtype)
    _fir_calls(x, zi)[name]()
    assert launches == []


@pytest.mark.parametrize("impl", ["auto", "cuda"])
@pytest.mark.parametrize("tuple_input", [False, True])
def test_pll_f64_device_tensor_raises(launches, impl, tuple_input):
    x = on_card((2, 16), torch.float64)
    batch = (2, 2) if tuple_input else (2,)
    st = tpll.pll_init(batch, torch.float64, "cpu")
    with pytest.raises(TypeError, match="float32"):
        tpll.pll((x, x) if tuple_input else x, st, impl=impl, **PLL_KW)
    assert launches == []


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_pll_f32_device_tensor_reaches_the_kernel(launches, impl):
    x = on_card((2, 16), torch.float32)
    tpll.pll(x, tpll.pll_init((2,), torch.float32, "cpu"), impl=impl,
             **PLL_KW)
    assert launches == ["rtsdr_pll"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pll_auto_cpu_tensor_runs_the_loop(launches, dtype):
    x = torch.ones((2, 16), dtype=dtype)
    nco_i, _, _ = tpll.pll(x, tpll.pll_init((2,), dtype, "cpu"), **PLL_KW)
    assert launches == [] and nco_i.dtype == dtype


@pytest.mark.parametrize("entry", ["iq", "fm", "fm_audio"])
@pytest.mark.parametrize("what", ["raw", "state"])
def test_ingest_wrong_dtype_on_device_raises(launches, entry, what):
    raw = on_card((2, 200), torch.uint8 if what == "state" else torch.int16)
    sd = torch.float64 if what == "state" else torch.float32
    zi = torch.zeros((2, 30), dtype=sd)
    p = torch.zeros((2,), dtype=sd)
    calls = {
        "iq": lambda: ingestfir.ingest_fir_decimate(raw, H, zi, zi, 10),
        "fm": lambda: ingestfir.ingest_fir_demod(raw, H, zi, zi, p, p, 10),
        "fm_audio": lambda: ingestfir.ingest_fir_demod_audio(
            raw, H, zi, zi, p, p, 10, H, zi, 5),
    }
    with pytest.raises(TypeError):
        calls[entry]()
    assert launches == []


RRC_H = coeffs.rrc_taps(57e3, 31)


def _resample_call(dtype, n=160, on_device=True):
    mk = ((lambda *s: on_card(s, dtype)) if on_device
          else (lambda *s: torch.zeros(s, dtype=dtype)))
    e = mk(2, n)
    return lambda: cuda_resample.resample_mul2_rrc(
        e, e, e, H, mk(2, 2, 30), RRC_H, mk(2, 2, 30), 19, 80)


def test_resample_f32_device_tensor_reaches_the_kernel(launches, monkeypatch):
    # the carried tail is made with stock ops after the launch
    monkeypatch.setattr(cuda_resample, "resample_mul2_tail",
                        lambda *a: torch.zeros(2, 2, 30))
    rrc, new_zi, new_rrc_zi = _resample_call(torch.float32)()
    assert launches == ["rtsdr_resample_rrc"]
    assert rrc.shape == (2, 2, 38) and new_rrc_zi.shape == (2, 2, 30)


def test_resample_f64_device_tensor_raises(launches):
    with pytest.raises(TypeError, match="float32"):
        _resample_call(torch.float64)()
    assert launches == []


def test_resample_empty_or_ragged_device_tensor_raises(launches):
    with pytest.raises(ValueError, match="empty"):
        _resample_call(torch.float32, n=0)()
    with pytest.raises(ValueError, match="do not divide"):
        _resample_call(torch.float32, n=161)()
    assert launches == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resample_cpu_tensor_runs_the_plain_version(launches, dtype):
    rrc, _, _ = _resample_call(dtype, on_device=False)()
    assert launches == [] and rrc.dtype == dtype


def _mix_call(dtype, n=160, on_device=True, impl="auto"):
    mk = ((lambda *s: on_card(s, dtype)) if on_device
          else (lambda *s: torch.zeros(s, dtype=dtype)))
    e = mk(2, n)
    return lambda: cuda_resample.resample_mul2(e, e, e, H, mk(2, 2, 30), 19,
                                               80, impl=impl)


@pytest.mark.parametrize("impl", ["auto", "pair"])
def test_mix_f32_device_tensor_reaches_the_kernel(launches, monkeypatch,
                                                  impl):
    monkeypatch.setattr(cuda_resample, "resample_mul2_tail",
                        lambda *a: torch.zeros(2, 2, 30))
    y, new_zi = _mix_call(torch.float32, impl=impl)()
    assert launches == ["rtsdr_resample_mix"]
    assert y.shape == (2, 2, 38) and new_zi.shape == (2, 2, 30)


def test_mix_f64_empty_or_ragged_device_tensor_raises(launches):
    with pytest.raises(TypeError, match="float32"):
        _mix_call(torch.float64)()
    with pytest.raises(ValueError, match="empty"):
        _mix_call(torch.float32, n=0)()
    with pytest.raises(ValueError, match="do not divide"):
        _mix_call(torch.float32, n=161)()
    assert launches == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mix_cpu_tensor_runs_the_plain_version(launches, dtype):
    y, _ = _mix_call(dtype, on_device=False)()
    assert launches == [] and y.dtype == dtype


def test_ingest_halo_on_device_reaches_the_iq_entry(launches):
    raw = on_card((2, 2 * 200), torch.uint8)
    zi = torch.zeros((2, 2, 30))
    y_i, _, _, _ = ingestfir.ingest_fir_decimate(raw, H, zi, zi, 10,
                                                 segments=2)
    assert launches == ["rtsdr_ingest_iq"] and y_i.shape == (2, 2, 10)
    with pytest.raises(ValueError, match="fewer"):
        ingestfir.ingest_fir_decimate(on_card((2, 2 * 40), torch.uint8), H,
                                      zi, zi, 10, segments=2)
    with pytest.raises(ValueError, match="segments"):
        ingestfir.ingest_fir_decimate(on_card((2, 2 * 201), torch.uint8), H,
                                      zi, zi, 10, segments=4)
    assert launches == ["rtsdr_ingest_iq"]


def test_ingest_bank_on_device_reaches_its_own_entry(launches):
    raw = on_card((2, 200), torch.uint8)
    zi = torch.zeros((2, 30))
    p = torch.zeros((2,))
    out = ingestfir.ingest_fir_demod_audio(
        raw, H, zi, zi, p, p, 10, H, zi, 5, emit_fm=False, bank_h=[H, H, H],
        bank_zi=zi)
    assert launches == ["rtsdr_ingest_fm_audio_bank"]
    assert out[0] is None and len(out[7]) == 3
    with pytest.raises(TypeError):
        ingestfir.ingest_fir_demod_audio(
            raw, H, zi, zi, p, p, 10, H, zi, 5, bank_h=[H],
            bank_zi=zi.double())
    assert launches == ["rtsdr_ingest_fm_audio_bank"]


def test_no_wrapper_falls_back_from_its_kernel():
    """Dispatch is by ``is_cuda`` alone and nothing catches a kernel's
    failure: no ``try`` in any wrapper that launches."""
    import inspect
    import re

    for fn, gate in ((cuda_resample.resample_mul2_rrc, "extract.is_cuda"),
                     (cuda_resample.resample_mul2, "extract.is_cuda"),
                     (ingestfir.ingest_fir_decimate, "raw_u8.is_cuda"),
                     (ingestfir.ingest_fir_demod_audio, "raw_u8.is_cuda")):
        src = inspect.getsource(fn)
        assert f"if not {gate}:" in src
        assert not re.search(r"\btry:|\bexcept\b", src)
    assert not re.search(r"\btry:|\bexcept\b",
                         inspect.getsource(_cuda.launch))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16])
def test_pipelines_refuse_other_dtypes_on_a_cuda_device(dtype):
    with pytest.raises(TypeError, match="float32 only"):
        require_kernel_dtype(torch.device("cuda"), dtype)
    require_kernel_dtype(torch.device("cuda"), torch.float32)
    require_kernel_dtype(torch.device("cpu"), dtype)


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_receiver_route_does_not_depend_on_dtype(monkeypatch, dtype, stereo):
    """The default receiver goes through ``ingest_fir_demod_audio`` and (in
    stereo) ``fir_bank_carried`` with the mixer pre-op in float64 as in
    float32: there is no dtype-gated second route that a CUDA tensor could
    take around the kernels."""
    from rtsdr_tpu_torch.pipeline import audio as taudio
    from rtsdr_tpu_torch.pipeline import receiver as treceiver

    seen = []

    def spy(mod, name):
        inner = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.append((name, kw.get("pre", "none")))
            return inner(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(treceiver, "ingest_fir_demod_audio")
    spy(taudio, "fir_bank_carried")
    rx = Receiver(MODE0, (1,), dtype, device="cpu", enable_rds=False,
                  enable_stereo=stereo, pll_impl="loop", pll_loop_div=8)
    raw = np.random.default_rng(7).integers(
        0, 256, (1, MODE0.block_size), dtype=np.uint8)
    _, out = rx.step(rx.init(), torch.as_tensor(raw))
    assert out.left.dtype == dtype
    want = [("ingest_fir_demod_audio", "none")]
    if stereo:
        want.append(("fir_bank_carried", "mul2"))
    assert seen == want


def test_frontend_auto_is_fused_in_any_dtype(monkeypatch):
    from rtsdr_tpu_torch.pipeline import frontend as tfrontend

    seen = []
    inner = tfrontend.ingest_fir_demod
    monkeypatch.setattr(
        tfrontend, "ingest_fir_demod",
        lambda *a, **kw: seen.append(a[2].dtype) or inner(*a, **kw))
    raw = torch.zeros((MODE0.block_size,), dtype=torch.uint8)
    for dtype in (torch.float32, torch.float64):
        fe = make_frontend(MODE0, dtype, device="cpu")
        fm, _ = fe(tfrontend.frontend_init(MODE0, (), dtype, "cpu"), raw)
        assert fm.dtype == dtype
    assert seen == [torch.float32, torch.float64]


# --------------------------------------- the wideband receiver's routes

def test_frontend_iq_on_a_device_tensor_reaches_the_fir_kernel(launches):
    """'iq' (float I/Q from the channelizer): the RF low-pass is the
    FIR-bank kernel at stride 10 for a CUDA tensor, float64 raises; 'if'
    has no FIR at all."""
    from rtsdr_tpu_torch.pipeline import frontend as tfrontend

    fe = make_frontend(MODE0, impl="iq", device="cpu")
    st = tfrontend.frontend_init(MODE0, (3,), device="cpu")
    fm, _ = fe(st, on_card((3, 2, 400), torch.float32))
    assert launches == ["rtsdr_fir_bank"] and tuple(fm.shape) == (3, 40)
    with pytest.raises(TypeError, match="float32"):
        fe(st, on_card((3, 2, 400), torch.float64))
    assert launches == ["rtsdr_fir_bank"]
    fe = make_frontend(MODE0, impl="if", device="cpu")
    fm, new = fe(st, torch.ones((3, 2, 40)))
    assert launches == ["rtsdr_fir_bank"] and tuple(fm.shape) == (3, 40)
    assert new.zi_i is st.zi_i


@pytest.mark.parametrize("impl,first", [("composed", "composed"),
                                        ("pfb", "pfb")])
def test_wideband_route_is_chosen_by_arguments_alone(monkeypatch, impl,
                                                     first):
    """``channelizer_impl`` decides the front door and ``frontend_impl``
    follows it ('if' behind the composed kernel, 'iq' behind the two-stage
    channelizer); the dtype or the channel count decide nothing."""
    from rtsdr_tpu_torch.pipeline import wideband as twb

    seen = []
    for name in ("composed_channelize_u8", "pfb_channelize_u8"):
        inner = getattr(twb, name)
        monkeypatch.setattr(
            twb, name, lambda *a, _n=name, _f=inner, **k: (
                seen.append(_n.split("_")[0]), _f(*a, **k))[1])
    made = []
    inner_rx = twb.make_receiver
    monkeypatch.setattr(
        twb, "make_receiver", lambda *a, **k: (
            made.append(k["frontend_impl"]), inner_rx(*a, **k))[1])
    init, step = twb.make_wideband_receiver(
        MODE0, 2, enable_rds=False, enable_stereo=False,
        channelizer_impl=impl, device="cpu")
    raw = torch.full((2 * MODE0.block_size,), 128, dtype=torch.uint8)
    _, out = step(init(), raw)
    assert seen == [first]
    assert made == ["if" if impl == "composed" else "iq"]
    assert tuple(out.mono.shape) == (2, MODE0.audio_len)
