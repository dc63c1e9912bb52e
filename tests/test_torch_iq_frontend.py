"""The signal-path head: the port's ``IQFrontEnd`` (the decimator on K8's
plain version, the spectrum on K4f's) against the JAX package's on the
CPU, with decimation 1 (the app's) and 4, IQ inversion on and off, over
two blocks.  Baseband and decimator state agree to >= 100 dB; spectra to
<= 0.01 dB within 60 dB of each frame's peak."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.iq_frontend import IQFrontEnd as JaxFrontEnd
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd
from sdrplusplusbrown_tpu_torch.ops.logmmse import IFNRLogMMSE

from torch_parity import (FS, assert_spectra_close, assert_state_close,
                          port_f32_handoff, snr_db, wfm_iq)  # noqa: F401


@pytest.mark.parametrize("decim,invert", [(1, False), (4, False), (4, True)])
def test_frontend_matches_jax(decim, invert):
    jf = JaxFrontEnd(FS, decim_ratio=decim, invert_iq=invert)
    pf = IQFrontEnd(FS, decim_ratio=decim, invert_iq=invert, device="cpu")
    assert pf.in_multiple == jf.in_multiple
    T = 2 * pf.in_multiple if decim == 1 else pf.in_multiple
    x = wfm_iq(2 * T, np.linspace(-0.2e6, 0.25e6, 3), seed=decim)
    js, ps = jf.init_state(), pf.init_state()
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        (jb, jspec), js = jf.apply(None, js, jnp.asarray(xb))
        (pb, pspec), ps = pf.apply(None, ps, torch.from_numpy(xb))
        assert pb.shape == (T // decim,) and pb.dtype == torch.complex64
        assert snr_db(np.asarray(jb), pb.numpy()) >= 100.0
        assert pspec.shape == np.asarray(jspec).shape
        assert_spectra_close(np.asarray(jspec), pspec.numpy())
        assert_state_close(js, ps, 100.0)
    # the state tree converts both ways unchanged
    back = convert.state_to_jax(convert.state_from_jax(js, device="cpu"))
    assert_state_close(js, convert.state_from_jax(back, device="cpu"), 300.0)


def test_frontend_unported_options_raise():
    # the DC blocker is ported (tests/test_torch_serving_units.py) and so
    # are the pluggable preprocessors (the IF noise reduction, against
    # the JAX package in tests/test_torch_noise_chain.py): state under
    # pre_<name>, the granularity the lcm with each one's
    fs = FS / 10
    nr = IFNRLogMMSE(fs)
    pre = IQFrontEnd(fs, dc_blocking=True, preprocessors=[("ifnr", nr)],
                     device="cpu")
    assert set(pre.init_state()) == {"dc", "pre_ifnr"}
    assert pre.in_multiple == np.lcm(IQFrontEnd(fs, device="cpu")
                                     .in_multiple, nr.in_multiple)
    assert set(IQFrontEnd(FS, dc_blocking=True, device="cpu")
               .init_state()) == {"dc"}
    if not torch.cuda.is_available():   # a default front end needs a card
        with pytest.raises(RuntimeError):
            IQFrontEnd(FS).init_state()
    pf = IQFrontEnd(FS, device="cpu")
    with pytest.raises(ValueError):
        pf.apply(None, pf.init_state(), torch.zeros(1000,
                                                    dtype=torch.complex64))
