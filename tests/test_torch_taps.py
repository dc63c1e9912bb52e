"""Design-time parity of the PyTorch port with the JAX package at the
broadcast-FM slice's configuration: every tap set, window and runtime
param bit-identical; the shared-VFO state with the same keys, shapes and
dtypes; state conversion exact both ways."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu.ops import taps as jtaps, windows as jwindows
from sdrplusplusbrown_tpu.ops.spectrum import SpectrumPath as JaxSpectrum
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import taps as ptaps, windows as pwindows
from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

from torch_parity import FS, leaves

OFFSETS = np.linspace(-1.0e6, 1.0e6, 8)


@pytest.fixture(scope="module")
def radios():
    return (JaxRadio(FS, DEMOD_WFM, pll_mode="normalize"),
            Radio(FS, DEMOD_WFM, device="cpu"))


def _designs(radio):
    vs = radio._build_vfo_shared()
    dem = radio.demod
    return {
        "stage0": vs.fused.taps,
        "polyphase": vs.rest[0][1].kernel,
        "bandwidth_fir": vs.base.fir.taps,
        "mpx_halfband0": dem.mpx_stages[0].taps,
        "mpx_halfband1": dem.mpx_stages[1].taps,
        "pilot_bpf": dem.pilot_taps,
        "pilot_phase_corr": np.asarray(dem.pilot_phase_corr),
        "audio_folded": dem.audio_poly.kernel,
        "inv_deviation": np.asarray(dem.quad.inv_deviation),
    }


DESIGNS = ["stage0", "polyphase", "bandwidth_fir", "mpx_halfband0",
           "mpx_halfband1", "pilot_bpf", "pilot_phase_corr", "audio_folded",
           "inv_deviation"]


@pytest.mark.parametrize("name", DESIGNS)
def test_designed_taps_bit_identical(radios, name):
    want = np.asarray(_designs(radios[0])[name])
    got = np.asarray(_designs(radios[1])[name])
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fft_size,rate", [(65536, 20.0), (4096, 200.0)])
def test_fft_window_bit_identical(fft_size, rate):
    j, p = JaxSpectrum(FS, fft_size, rate), SpectrumPath(FS, fft_size, rate,
                                                      device="cpu")
    assert (j.reshaper.keep, j.reshaper.interval) == \
        (p.reshaper.keep, p.reshaper.interval)
    np.testing.assert_array_equal(p.window, j.fft.window)
    assert p.floor_db == j.fft.floor_db


@pytest.mark.parametrize("name", sorted(jwindows.BY_NAME))
def test_windows_bit_identical(name):
    assert sorted(pwindows.BY_NAME) == sorted(jwindows.BY_NAME)
    for n in (7, 64, 4097):
        np.testing.assert_array_equal(pwindows.fft_window(name, n),
                                      jwindows.fft_window(name, n))


def test_tap_designers_bit_identical():
    cases = [("low_pass", (15000.0, 4000.0, 2.4e6)),
             ("band_pass_complex", (18750.0, 19250.0, 3000.0, 125000.0,
                                    True)),
             ("windowed_sinc_hz", (101, 50000.0, 600000.0))]
    for fn, args in cases:
        np.testing.assert_array_equal(getattr(ptaps, fn)(*args),
                                      getattr(jtaps, fn)(*args))


def test_fused_params_bit_identical(radios):
    jr, pr = radios
    jp = jr.make_params_shared(OFFSETS)
    pp = pr.make_params_shared(OFFSETS)
    jl, pl = list(leaves(jp)), list(leaves(pp))
    assert [k for k, _ in jl] == [k for k, _ in pl]
    for (k, a), (_, b) in zip(jl, pl):
        assert b.dtype == torch.float32, k
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=k)
    conv = convert.params_from_jax(jp, device="cpu")
    for (k, a), (_, b) in zip(leaves(conv), pl):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("C", [4, 8])
def test_init_state_shared_layout(radios, C):
    jr, pr = radios
    js = list(leaves(jr.init_state_shared(C)))
    ps = list(leaves(pr.init_state_shared(C)))
    assert [k for k, _ in js] == [k for k, _ in ps]
    for (k, a), (_, b) in zip(js, ps):
        a = np.asarray(a)
        b = convert.state_to_jax(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert pr.init_state_shared(C)["vfo"]["rest_decim"] == []


def test_state_round_trip_exact(radios):
    jr, _ = radios
    rng = np.random.default_rng(5)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        a = np.asarray(tree)
        v = rng.standard_normal(a.shape)
        if np.iscomplexobj(a):
            v = v + 1j * rng.standard_normal(a.shape)
        return v.astype(a.dtype)
    st = fill(jr.init_state_shared(8))
    back = convert.state_to_jax(convert.state_from_jax(st, device="cpu"))
    jl, bl = list(leaves(st)), list(leaves(back))
    assert [k for k, _ in jl] == [k for k, _ in bl]
    for (k, a), (_, b) in zip(jl, bl):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
