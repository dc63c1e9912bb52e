"""Kernel K1's plain version (the port's shared-VFO front end) against the
JAX package's front-end kernel in interpret mode: three consecutive blocks
of a stereo FM wideband, retuned before the third; IF planes and every
carried state leaf agree to >= 80 dB in the float32 handoff.  The bf16
handoff (the production default; at C >= 16 the carried tails are stored
in bf16 too) rounds at the same places in both packages; a rounding that
lands on the other side of a bf16 tie costs an ulp (~2^-8), so its bound is
70 dB.  The stage tails K1 now writes are exactly the former wrapper's
cat-slice-round of the stage inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import mono_frontend
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision
from sdrplusplusbrown_tpu_torch.ops.fir_kernel import poly_rows
from sdrplusplusbrown_tpu_torch.ops.precision import round_to

from torch_parity import (FS, assert_state_close, planes, port_f32_handoff,
                          snr_db, wfm_iq)  # noqa: F401

T = 36_000      # four of the TPU kernel's mix windows, the last one partial


@pytest.mark.parametrize("C,handoff,min_db", [(4, "float32", 80.0),
                                              (8, "float32", 80.0),
                                              (16, "bf16", 70.0)])
def test_frontend_matches_jax_kernel(C, handoff, min_db):
    jax_precision.set_handoff_dtype(handoff)
    port_precision.set_handoff_dtype(handoff)
    jvs = JaxRadio(FS, DEMOD_WFM, pll_mode="normalize")._build_vfo_shared()
    pvs = Radio(FS, DEMOD_WFM, device="cpu")._build_vfo_shared()
    offsets = np.linspace(-0.9e6, 0.9e6, C)
    retuned = offsets + np.linspace(-40e3, 35e3, C)
    x = wfm_iq(3 * T, offsets, seed=C)
    js = jvs.init_state(C)
    ps = convert.state_from_jax(js, device="cpu")
    launches = mono_frontend.mono_frontend_kernel.launches
    for b in range(3):
        offs = offsets if b < 2 else retuned
        xb = x[b * T:(b + 1) * T]
        (jbuf, m_if), js = jvs.apply(jvs.make_params(offs), js,
                                     jnp.asarray(xb), raw=True,
                                     _force_kernel=True)
        buf, ps = pvs.apply(pvs.make_params(offs), ps, planes(xb))
        want = np.asarray(jbuf)[:, :m_if]
        assert buf.shape == want.shape and buf.dtype == port_precision \
            .get_handoff_dtype()
        s = snr_db(want.astype(np.float32), buf.float().numpy())
        assert s >= min_db, (b, s)
        assert_state_close(js, ps, min_db)
    # CPU tensors run the plain version, never the kernel
    assert mono_frontend.mono_frontend_kernel.launches == launches


def _former_glue_tails(pipe, xr, xi, tail, omega, base, tails, tap_dt,
                       t_dt):
    """The stage tails as ``MonoVFOPipeline.apply`` built them before the
    kernel wrote them: each stage's input from the plain chain, then per
    stage cat, slice, ``round_to`` and ``complex``."""
    C = omega.shape[0]
    h0, kernels = pipe.taps(xr.device, tap_dt)
    y = mono_frontend.mono_mix_ref(pipe, xr, xi, tail, omega, base, h0)
    out = []
    for st, tc, ker in zip(pipe.stages, tails, kernels):
        tp = round_to(torch.cat([tc.real, tc.imag], dim=0).float(), t_dt)
        ext_end = round_to(torch.cat([tp, y], dim=1)[:, -st["carry"]:],
                           t_dt)
        out.append(torch.complex(ext_end[:C], ext_end[C:]))
        y = poly_rows(torch.cat([tp, y], dim=1), ker, st["I"], st["D"])
    return out


@pytest.mark.parametrize("C,handoff,min_db", [(4, "float32", 80.0),
                                              (16, "bf16", 70.0)])
def test_frontend_tails_match_former_glue_and_jax(C, handoff, min_db):
    """The new carried tail of every chained stage, which K1's plain
    version (and kernel) now returns: exactly the former wrapper's
    cat-slice-round of the stage inputs on each of two blocks, in the
    float32 handoff (float32 tails) and the bf16 one at C = 16 (bf16
    tails); after the two blocks, within ``min_db`` of the JAX package's
    state."""
    jax_precision.set_handoff_dtype(handoff)
    port_precision.set_handoff_dtype(handoff)
    h_dt = port_precision.get_handoff_dtype()
    t_dt = h_dt if C >= 16 else torch.float32
    jvs = JaxRadio(FS, DEMOD_WFM, pll_mode="normalize")._build_vfo_shared()
    pvs = Radio(FS, DEMOD_WFM, device="cpu")._build_vfo_shared()
    pipe = pvs.pipe()
    offsets = np.linspace(-0.85e6, 0.95e6, C)
    x = wfm_iq(2 * T, offsets, seed=20 + C)
    js = jvs.init_state(C)
    ps = convert.state_from_jax(js, device="cpu")
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        _, js = jvs.apply(jvs.make_params(offsets), js, jnp.asarray(xb),
                          raw=True, _force_kernel=True)
        params = pvs.make_params(offsets)
        xr, xi = planes(xb)
        base = pipe.base_phases(params["fused"], ps["fused"]["phase"], T)
        want = _former_glue_tails(pipe, xr, xi, ps["fused"]["tail"],
                                  params["fused"]["omega"], base,
                                  pvs.stage_tails(ps), h_dt, t_dt)
        _, ps = pvs.apply(params, ps, (xr, xi))
        got = pvs.stage_tails(ps)
        assert len(got) == len(want) == len(pipe.stages)
        for g, w in zip(got, want):
            assert g.dtype == torch.complex64
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    jt = pvs.stage_tails(convert.state_from_jax(js, device="cpu"))
    for g, w in zip(pvs.stage_tails(ps), jt):
        assert snr_db(w.numpy(), g.numpy()) >= min_db
