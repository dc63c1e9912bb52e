"""Kernel K1's plain version (the port's shared-VFO front end) against the
JAX package's front-end kernel in interpret mode: three consecutive blocks
of a stereo FM wideband, retuned before the third; IF planes and every
carried state leaf agree to >= 80 dB in the float32 handoff.  The bf16
handoff (the production default; at C >= 16 the carried tails are stored
in bf16 too) rounds at the same places in both packages; a rounding that
lands on the other side of a bf16 tie costs an ulp (~2^-8), so its bound is
70 dB."""

import numpy as np
import pytest

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import mono_frontend
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

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
