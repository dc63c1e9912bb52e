"""Kernels K2 + K3's plain versions (the port's WFM demod and audio
polyphase) against the JAX package's WFM kernels in interpret mode, with
the same IF planes fed to both: audio and the quad / mpx_decim / mpx_hist /
audio_rs state agree to >= 70 dB (the bound of tests/test_pallas_wfm.py).
The state K2 now returns is exactly the former wrapper's cat-slice-round
of the stage inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision
from sdrplusplusbrown_tpu_torch.ops import wfm_kernel
from sdrplusplusbrown_tpu_torch.ops.precision import round_to

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


def _former_glue_state(pipe, iq, m_if, state, dt):
    """quad / mpx_decim / mpx_hist as ``WFMDemodPipeline.apply`` built them
    before the kernels wrote them: from the plain version's stage inputs,
    per key cat, slice, ``round_to`` (and ``complex`` for quad)."""
    C = iq.shape[0] // 2
    *_, ins = wfm_kernel._wfm_demod_ref(pipe, iq, m_if, state["quad"],
                                        state["mpx_decim"],
                                        state["mpx_hist"], dt)
    last = round_to(iq[:, m_if - 1].float(), dt)
    tails = [round_to(t.float(), dt) for t in state["mpx_decim"]]
    hist = round_to(state["mpx_hist"].float(), dt)
    return {"quad": torch.complex(last[:C], last[C:])[:, None],
            "mpx_decim": [round_to(torch.cat([t, y], dim=1)[:, -t.shape[1]:],
                                   dt) for t, y in zip(tails, ins[:-1])],
            "mpx_hist": round_to(torch.cat([hist, ins[-1]], dim=1)
                                 [:, -pipe.K:], dt)}


@pytest.mark.parametrize("handoff", ["float32", "bf16"])
def test_wfm_state_matches_former_glue_and_jax(handoff):
    """The carried state K2's plain version (and kernels) now return:
    exactly the former wrapper's cat-slice-round of the stage inputs on
    each of two blocks, in both handoffs; after the two blocks within 70
    dB of the JAX package's (45 dB in bf16, a bf16 ulp either side of a
    tie)."""
    C = 4
    jax_precision.set_handoff_dtype(handoff)
    port_precision.set_handoff_dtype(handoff)
    dt = port_precision.get_handoff_dtype()
    jdem = JaxRadio(FS, DEMOD_WFM, pll_mode="normalize").demod
    pdem = Radio(FS, DEMOD_WFM, device="cpu").demod
    pipe = pdem.pipes()[0]
    x = _stereo_if(C, 2 * M_IF, seed=30)
    js = jdem.init_state((C,))
    ps = convert.state_from_jax(js, device="cpu")
    for b in range(2):
        xb = x[:, b * M_IF:(b + 1) * M_IF]
        xr = np.ascontiguousarray(xb.real)
        xi = np.ascontiguousarray(xb.imag)
        _, js = jdem.apply_planes(None, js, (jnp.asarray(xr),
                                             jnp.asarray(xi)),
                                  _force_kernel=True)
        iq = torch.from_numpy(np.concatenate([xr, xi])).to(dt)
        want = _former_glue_state(pipe, iq, M_IF, ps, dt)
        _, ps = pdem.apply_planes(None, ps, iq)
        for key in want:
            for (path, g), (_, w) in zip(leaves(ps[key], key),
                                         leaves(want[key], key)):
                assert g.dtype == w.dtype and g.shape == w.shape, path
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           msg=path)
    pst = convert.state_to_jax(ps)
    for key in ("quad", "mpx_decim", "mpx_hist"):
        for path, a in leaves(js[key], key):
            got = dict(leaves(pst[key], key))[path]
            assert snr_db(np.asarray(a), got) >= (
                70.0 if handoff == "float32" else 45.0), path
