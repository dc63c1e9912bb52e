"""The port's NFM demod + audio against the JAX package: the plain
version of kernel K7 (ops/demod_kernel.py) against ``FMAudioPipeline``
(the Pallas ``_demod_kernel`` in interpret mode), gate on and off, over
two calls; one port call at C = 16 against JAX's ``apply_chunked`` over
two 8-channel chunks; the plain FMDemod, Squelch and the 50 → 48 kHz
RationalResampler blocks against JAX's.  Float32 handoff.

Bounds: audio and state 80 dB (measured ≥ 119 dB: both sides use the
same minimax atan2, so only float32 sum order differs); exact zeros on a
channel whose gate has been closed from the start."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_NFM
from sdrplusplusbrown_tpu.ops import demod as jdemod
from sdrplusplusbrown_tpu.ops import resampler as jres
from sdrplusplusbrown_tpu.ops.demod_kernel import (
    _ATAN_C, apply_chunked, build_fm_audio_pipeline)
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import demod, demod_kernel, resampler

from torch_parity import (FS, assert_state_close, port_f32_handoff,
                          snr_db)  # noqa: F401

M_IF = 2000


def _radios():
    return (JaxRadio(FS, DEMOD_NFM, pll_mode="normalize"),
            Radio(FS, DEMOD_NFM, device="cpu"))


def _if(C, m, seed):
    """FM-like IF planes [2C, m]: a unit phasor with a wandering phase
    plus a little noise."""
    rng = np.random.default_rng(seed)
    dphi = 0.3 * np.sin(2 * np.pi * np.arange(m) / 97.0) \
        + 0.05 * rng.standard_normal((C, m))
    z = np.exp(1j * np.cumsum(dphi, axis=1)) \
        + 0.01 * rng.standard_normal((C, m))
    return np.concatenate([z.real, z.imag]).astype(np.float32)


def _states(jr, C):
    st = jr.init_state((C,))
    return ({"demod": st["demod"], "af": st["af_resamp"]},
            {"demod": convert.state_from_jax(st["demod"], device="cpu"),
             "af": convert.state_from_jax(st["af_resamp"], device="cpu")})


def test_coefficients_and_geometry_match():
    jr, pr = _radios()
    assert demod_kernel._ATAN_C == _ATAN_C
    jp = build_fm_audio_pipeline(jr.demod, jr.af_resamp, 8, interpret=True)
    pp = pr.fm_audio_pipe()
    assert (pp.adv_if, pp.adv_aud) == (jp.adv_if, jp.adv_aud) == (3200, 3072)
    assert pp.plan(M_IF) == {"m_aud": 1920, "n_aud": 3072, "n_if": 3200}
    np.testing.assert_array_equal(pp.hf, np.asarray(jr.demod.fir.taps,
                                                    np.float32))


@pytest.mark.parametrize("C", [4, 8])
@pytest.mark.parametrize("gated", [False, True])
def test_fm_audio_matches_jax_kernel(C, gated):
    jr, pr = _radios()
    jp = build_fm_audio_pipeline(jr.demod, jr.af_resamp, C, interpret=True)
    pp = pr.fm_audio_pipe()
    gate = np.ones(C, np.float32)
    if gated:
        gate[1::3] = 0.0
    js, ps = _states(jr, C)
    for b in range(2):
        iq = _if(C, M_IF, seed=10 * b + C)
        (ja, jm), js["demod"], js["af"] = jp.apply(
            jnp.asarray(gate), js["demod"], js["af"], jnp.asarray(iq), M_IF,
            raw_audio=True)
        (pa, pm), ps["demod"], ps["af"] = pp.apply(
            torch.from_numpy(gate), ps["demod"], ps["af"],
            torch.from_numpy(iq), M_IF, raw_audio=True)
        ja = np.asarray(ja)
        assert pm == jm and pa.shape == ja.shape == (C, 3072)
        assert snr_db(ja[:, :jm], pa.numpy()[:, :pm]) >= 80.0
        # the padding is computed from zero IF, as on the TPU
        assert snr_db(ja, pa.numpy()) >= 80.0
        assert_state_close(js, ps, 80.0)
        closed = gate == 0
        assert not pa[torch.from_numpy(closed)].any()
        assert pa[torch.from_numpy(~closed)].abs().max() > 0.1


def test_one_launch_matches_jax_chunks():
    """C = 16 in one port call == JAX's chunked launch over 8-channel
    pipes (the TPU's VMEM cap; the port has no chunking)."""
    C = 16
    jr, pr = _radios()
    jp8 = build_fm_audio_pipeline(jr.demod, jr.af_resamp, 8, interpret=True)
    gate = (np.arange(C) % 4 != 3).astype(np.float32)
    iq = _if(C, M_IF, seed=3)
    js, ps = _states(jr, C)
    ja, jd, jaf = apply_chunked(jp8, jnp.asarray(gate), js["demod"],
                                js["af"], jnp.asarray(iq), M_IF, C)
    pa, pd, paf = pr.fm_audio_pipe().apply(
        torch.from_numpy(gate), ps["demod"], ps["af"], torch.from_numpy(iq),
        M_IF)
    assert pa.shape == (C, 1920) and pa.dtype == torch.float32
    assert snr_db(np.asarray(ja), pa.numpy()) >= 80.0
    assert_state_close({"d": jd, "a": jaf}, {"d": pd, "a": paf}, 80.0)


def test_atan2_poly_accuracy():
    rng = np.random.default_rng(0)
    im = torch.from_numpy(rng.standard_normal(20_000).astype(np.float32))
    re = torch.from_numpy(rng.standard_normal(20_000).astype(np.float32))
    im[:4] = torch.tensor([0.0, -0.0, 1.0, -1.0])
    re[:4] = torch.tensor([0.0, 0.0, 0.0, -1.0])
    got = demod_kernel.atan2_poly(im, re)
    want = torch.atan2(im.double(), re.double())
    want[:2] = 0.0                      # exact silence for a zero product
    assert (got.double() - want).abs().max() <= 2.4e-7 * 2


def test_fm_demod_and_squelch_blocks_like_jax():
    jr, pr = _radios()
    C = 3
    iq = _if(C, 500, seed=5)
    iq[:, 200] = 0.0
    jy, jst = jr.demod.apply_planes(None, jr.demod.init_state((C,)),
                                    (jnp.asarray(iq[:C]),
                                     jnp.asarray(iq[C:])))
    py, pst = pr.demod.apply_planes(
        None, pr.init_state((C,))["demod"],
        (torch.from_numpy(iq[:C]), torch.from_numpy(iq[C:])))
    assert snr_db(np.asarray(jy), py.numpy()) > 100.0
    assert_state_close(jst, pst, 100.0)
    x = (iq[:C] + 1j * iq[C:]).astype(np.complex64)
    x[1] *= 1e-4
    for level in (-100.0, -30.0, 10.0):
        jg, _ = jdemod.Squelch(level).apply(None, None, jnp.asarray(x))
        pg, _ = demod.Squelch(level).apply(None, None, torch.from_numpy(x))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def test_af_resampler_50k_to_48k_like_jax():
    jr = jres.RationalResampler(50e3, 48e3)
    pr = resampler.RationalResampler(50e3, 48e3)
    assert [n for n, _ in pr.chain.named_blocks] == ["resamp"]
    jpoly, ppoly = jr.chain.named_blocks[0][1], pr.chain.named_blocks[0][1]
    assert (ppoly.interp, ppoly.decim, ppoly.tpp) == (24, 25, 80)
    np.testing.assert_array_equal(ppoly.kernel, jpoly.kernel)
    assert (pr.in_multiple, pr.ratio) == (jr.in_multiple, jr.ratio)
    rng = np.random.default_rng(6)
    jst = jr.init_state((2,), jnp.float32)
    pst = pr.init_state((2,), torch.float32)
    for _ in range(2):
        xb = rng.standard_normal((2, 1000)).astype(np.float32)
        jy, jst = jr.apply(None, jst, jnp.asarray(xb))
        py, pst = pr.apply(None, pst, torch.from_numpy(xb))
        assert py.shape == (2, 960)
        assert snr_db(np.asarray(jy), py.numpy()) > 100.0
        assert_state_close(jst, pst, 100.0)
