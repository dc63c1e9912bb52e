"""The receiver's noise path in its pipelines: the port's radio IF chain
with the noise blanker and the FM IF filter (``Radio.apply``, and
``apply_shared``/``apply_channelized``, which leave their fused routes for
it as the JAX package's do) and ``IQFrontEnd(preprocessors=[("ifnr",
IFNRLogMMSE)])`` against the JAX package's on the CPU, op by op, with the
same seeded inputs: audio, baseband and every state leaf to >= 80 dB
(integer and bool leaves equal), spectra by ``assert_spectra_close``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.iq_frontend import IQFrontEnd as JaxFrontEnd
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
from sdrplusplusbrown_tpu.ops import logmmse as jlm
from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd
from sdrplusplusbrown_tpu_torch.models.radio import (Radio, DEMOD_NFM,
                                                     DEMOD_USB, DEMOD_WFM)
from sdrplusplusbrown_tpu_torch.ops import logmmse as plm

from torch_parity import (FS, assert_close, assert_nr_state,
                          assert_spectra_close, assert_state_close, nfm_iq,
                          planes, port_f32_handoff, speech_like,
                          wfm_iq)  # noqa: F401

MIN_DB = 80.0


# ---- the radio's IF chain --------------------------------------------------

T_RADIO = 24_000
NB_OFFS = np.linspace(-0.9e6, 0.7e6, 4) + 917.0


def _spiky_nfm(T: int, offs, seed: int) -> np.ndarray:
    """NFM carriers with tones (torch_parity.nfm_iq) and an impulse train
    every 4 001 samples (the blanker's work)."""
    x = nfm_iq(T, offs, range(len(offs)), seed=seed)
    x[::4001] += 20.0
    return x


@pytest.mark.parametrize("nb,fmif", [(True, False), (False, True),
                                     (True, True)])
@pytest.mark.parametrize("demod", [DEMOD_NFM, DEMOD_USB])
def test_radio_if_chain_matches_jax(demod, nb, fmif):
    """``Radio.apply`` with the blanker and/or the FM IF filter and the
    squelch, as the app builds a radio, batch (); three blocks."""
    jr = JaxRadio(FS, demod, squelch_enabled=True, nb_enabled=nb,
                  fmif_enabled=fmif)
    pr = Radio(FS, demod, squelch_enabled=True, nb_enabled=nb,
               fmif_enabled=fmif, device="cpu")
    x = _spiky_nfm(3 * T_RADIO, NB_OFFS[1:2], seed=7)
    js, ps = jr.init_state(()), pr.init_state(())
    assert ("nb" in ps) == nb and ("fmif" in ps) == fmif
    off = float(NB_OFFS[1])
    for b in range(3):
        xb = x[b * T_RADIO:(b + 1) * T_RADIO]
        ja, js = jr.apply(jr.make_params(off), js, jnp.asarray(xb))
        pa, ps = pr.apply(pr.make_params(off), ps, torch.from_numpy(xb))
        assert_close(ja, pa, f"block {b}")
        assert_state_close(js, ps, MIN_DB)


@pytest.mark.parametrize("route", ["shared", "channelized"])
def test_bank_if_chain_matches_jax(route):
    """``apply_shared`` and ``apply_channelized`` with the blanker and the
    FM IF filter leave their fused routes, as the JAX package's do, and
    agree with them; C = 4 NFM channels."""
    kw = dict(squelch_enabled=True, nb_enabled=True, fmif_enabled=True)
    jr, pr = JaxRadio(FS, DEMOD_NFM, **kw), Radio(FS, DEMOD_NFM,
                                                  device="cpu", **kw)
    T = 2 * T_RADIO
    x = _spiky_nfm(2 * T, NB_OFFS, seed=8)
    if route == "shared":
        js, ps = jr.init_state_shared(4), pr.init_state_shared(4)
        jp, pp = jr.make_params_shared(NB_OFFS), pr.make_params_shared(
            NB_OFFS)
    else:
        js, ps = jr.init_state_channelized(4), pr.init_state_channelized(4)
        jp = jr.make_params_channelized(NB_OFFS)
        pp = pr.make_params_channelized(NB_OFFS)
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        fn = "apply_shared" if route == "shared" else "apply_channelized"
        ja, js = getattr(jr, fn)(jp, js, jnp.asarray(xb))
        pa, ps = getattr(pr, fn)(pp, ps, planes(xb))
        assert pa.shape == np.asarray(ja).shape == (4, 2, T // 50)
        assert_close(ja, pa, f"block {b}")
        assert_state_close(js, ps, MIN_DB)
    if route == "channelized":
        with pytest.raises(NotImplementedError, match="raw_audio"):
            pr.apply_channelized(pp, ps, planes(xb), raw_audio=True)


def test_wfm_if_chain_runs_on_the_bank():
    """WFM with the blanker through ``apply_shared``: the non-fused route
    (the WFM demod on the complex IF), against the JAX package's."""
    jr = JaxRadio(FS, DEMOD_WFM, nb_enabled=True)
    pr = Radio(FS, DEMOD_WFM, nb_enabled=True, device="cpu")
    T = 2 * T_RADIO
    x = wfm_iq(T, NB_OFFS[:2], seed=3)
    ja, js = jr.apply_shared(jr.make_params_shared(NB_OFFS[:2]),
                             jr.init_state_shared(2), jnp.asarray(x))
    pa, ps = pr.apply_shared(pr.make_params_shared(NB_OFFS[:2]),
                             pr.init_state_shared(2), planes(x))
    assert_close(ja, pa)
    assert_state_close(js, ps, MIN_DB)


# ---- the front end with the IF NR preprocessor ---------------------------------

def test_frontend_preprocessor_matches_jax():
    """``IQFrontEnd(preprocessors=[("ifnr", IFNRLogMMSE)])`` with the DC
    blocker, at 24 kS/s: the NR after the blocker, before the spectrum,
    its state under ``pre_ifnr``, the granularity the lcm."""
    fs = 24_000.0
    jnr, pnr = jlm.IFNRLogMMSE(fs), plm.IFNRLogMMSE(fs)
    jf = JaxFrontEnd(fs, dc_blocking=True, fft_size=256, fft_rate=50.0,
                     preprocessors=[("ifnr", jnr)])
    pf = IQFrontEnd(fs, dc_blocking=True, fft_size=256, fft_rate=50.0,
                    preprocessors=[("ifnr", pnr)], device="cpu")
    assert pf.in_multiple == jf.in_multiple == np.lcm(480, 240)
    core = pnr.core
    need = core.NOISE_FRAMES * core.Slen
    T = 10 * pf.in_multiple
    x = speech_like(need + 3 * T, fs, 12) + (0.1 + 0.05j)
    js, ps = jf.init_state(), pf.init_state()
    assert set(ps) == {"dc", "pre_ifnr"}
    js["pre_ifnr"] = jnr.prime(js["pre_ifnr"], jnp.asarray(x[:need]))
    ps["pre_ifnr"] = pnr.prime(ps["pre_ifnr"], torch.from_numpy(x[:need]))
    for b in range(3):
        xb = x[need + b * T:need + (b + 1) * T]
        (jb, jspec), js = jf.apply(None, js, jnp.asarray(xb))
        (pb, pspec), ps = pf.apply(None, ps, torch.from_numpy(xb))
        assert_close(jb, pb, f"block {b}")
        assert_spectra_close(np.asarray(jspec), pspec.numpy())
        assert_nr_state(js, ps)
