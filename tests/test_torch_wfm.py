"""Kernels K2 + K3's plain versions (the port's WFM demod and audio
polyphase) against the JAX package's WFM kernels in interpret mode, with
the same IF planes fed to both: audio and the quad / mpx_decim / mpx_hist /
audio_rs state agree to >= 70 dB (the bound of tests/test_pallas_wfm.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import wfm_kernel

from torch_parity import (FS, leaves, port_f32_handoff, snr_db,
                          tone_hz)  # noqa: F401

IF_RATE = 500_000.0
M_IF = 10_000   # 20 ms of IF: 2500 MPX, 960 audio samples


def _stereo_if(C: int, n: int, seed: int) -> np.ndarray:
    """[C, n] complex IF: channel k a stereo FM broadcast at baseband."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / IF_RATE
    x = np.zeros((C, n), np.complex64)
    for k in range(C):
        tone = np.sin(2 * np.pi * tone_hz(k) * t)
        mpx = (0.45 * tone + 0.45 * tone * -np.cos(2 * np.pi * 38_000 * t)
               + 0.1 * np.sin(2 * np.pi * 19_000 * t))
        x[k] = np.exp(1j * 2 * np.pi * 75_000 * np.cumsum(mpx) / IF_RATE)
    x += 1e-3 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


@pytest.mark.parametrize("C", [4, 8])
def test_wfm_demod_matches_jax_kernel(C):
    jdem = JaxRadio(FS, DEMOD_WFM, pll_mode="normalize").demod
    pdem = Radio(FS, DEMOD_WFM, device="cpu").demod
    x = _stereo_if(C, 2 * M_IF, seed=C)
    js = jdem.init_state((C,))
    ps = convert.state_from_jax(js, device="cpu")
    k2 = wfm_kernel.wfm_demod_kernel.launches
    for b in range(2):
        xb = x[:, b * M_IF:(b + 1) * M_IF]
        xr = np.ascontiguousarray(xb.real)
        xi = np.ascontiguousarray(xb.imag)
        ja, js = jdem.apply_planes(None, js, (jnp.asarray(xr),
                                              jnp.asarray(xi)),
                                   _force_kernel=True)
        pa, ps = pdem.apply_planes(None, ps, tuple(
            convert.state_from_jax([xr, xi], device="cpu")))
        ja = np.asarray(ja)
        assert pa.shape == ja.shape == (C, 2, M_IF // 4 * 48 // 125)
        s = snr_db(ja, pa.numpy())
        assert s >= 70.0, (b, s)
        pst = convert.state_to_jax(ps)
        for key in ("quad", "mpx_decim", "mpx_hist", "audio_rs"):
            for path, a in leaves(js[key], key):
                got = dict(leaves(pst[key], key))[path]
                assert got.shape == np.asarray(a).shape, path
                assert snr_db(np.asarray(a), got) >= 70.0, path
    # stereo decoded: channel 0's tone sits in L
    tail = pa.numpy()[0, :, pa.shape[-1] // 2:]
    assert np.mean(tail[0] ** 2) > 50 * np.mean(tail[1] ** 2)
    assert wfm_kernel.wfm_demod_kernel.launches == k2
