"""The Radio's forms beyond the app's defaults against the JAX package on
the CPU (its blocks under ``jax.jit``: torch_parity.jit_methods), with
the same seeded inputs (audio and every state leaf >= 80 dB, two or three
carried blocks):

  * WFM: mono (``stereo=False``), the scan PLL (``pll_mode="scan"``,
    K13's plain version in the stereo section: against the JAX route with
    its VCO lagged one sample as the port's is, and the port less that
    lag against the JAX route as it ships), the 15 kHz FIR and no
    low-pass (``BroadcastFM(low_pass=False)``);
  * the separate AF resampler with the standalone ``Deemphasis``: WFM at
    a 32 kHz audio rate (the FIR form, 50 µs), NFM at 400 kHz with 75 µs
    (a pole slower than the 512-tap horizon: the recurrence), NFM at 48
    kHz with 50 µs, and ``Deemphasis.apply`` alone in both forms;
  * RAW (I and Q as L and R);
  * ``FMDemod``'s high-pass, band-pass and unfiltered forms;
  * a registered demod provider through ``Radio`` and through the app's
    ``set_demod`` / ``list_demods`` / ``get_demod`` (the JAX app's
    answers);
  * WFM with the squelch through ``apply_shared`` (the complex IF through
    ``_post_vfo``, as the JAX package's route), batch (2,), squelch open
    on the station and closed off it.

The WFM station is torch_parity.rds_fm_iq (a stereo broadcast with a 1 kHz
tone in L and RDS) at 1 MS/s."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.models import radio as jax_radio_mod
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
from sdrplusplusbrown_tpu.ops import demod as jax_demod
from sdrplusplusbrown_tpu.ops import recurrence as jax_rec
from sdrplusplusbrown_tpu.ops import wfm as jax_wfm
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.models import radio as radio_mod
from sdrplusplusbrown_tpu_torch.models.radio import (Radio, DEMOD_NFM,
                                                     DEMOD_RAW, DEMOD_WFM)
from sdrplusplusbrown_tpu_torch.ops import demod, recurrence, wfm

from torch_parity import (assert_close, assert_state_close, jit_methods,
                          planes, port_f32_handoff, rds_fm_iq)  # noqa: F401

MIN_DB = 80.0
FS = 1_000_000.0
WFM_OFF = 100e3
NFM_OFF = -150e3


def _capture(T: int, seed: int = 0) -> np.ndarray:
    """The WFM station at +100 kHz and an NFM carrier (1 kHz tone, 2.5
    kHz peak deviation) at −150 kHz."""
    x = rds_fm_iq(T, FS, offset=WFM_OFF, seed=seed)
    n = np.arange(T)
    tone = 0.8 * np.sin(2 * np.pi * 1000.0 * n / FS)
    x = x + 0.3 * np.exp(2j * np.pi * (NFM_OFF * n / FS
                                       + 2500.0 * np.cumsum(tone) / FS))
    return x.astype(np.complex64)


def _separation(audio) -> float:
    """L over R in dB of [2, n] audio (the 1 kHz tone is in L alone)."""
    a = np.asarray(audio, np.float64)
    return 10 * np.log10(np.mean(a[0] ** 2) / np.mean(a[1] ** 2))


def _run(kw, offset, blocks=2, seconds=0.06, lag_pll=False, unlag=False):
    """Both packages' Radio(FS, **kw).apply over
    ``blocks`` blocks of ~``seconds``; audio and state compared each
    block.  ``lag_pll``: the JAX WFM demod's PLL lagged one sample
    (``_LaggedPLL``), its lag's state held against the port's
    ``pilot_lag``.  ``unlag``: the port's scan route with its VCO lag
    taken out (``_Unlagged``), against the JAX route as it is.  Returns
    (port radio, port state, last audio)."""
    jr = JaxRadio(FS, **kw)
    pr = Radio(FS, device="cpu", **kw)
    assert pr.in_multiple == jr.in_multiple
    if lag_pll:
        jr.demod.pll = _LaggedPLL(jr.demod)
    if unlag:
        pr.demod.pilot_lag = _Unlagged(pr.demod.pilot_lag)
    # every stage after the VFO under jit; the VFO's NCO op by op: under
    # jit its carried phase, which these blocks end on a whole number of
    # turns at the NFM offset, rounds to the other side of the 2π wrap
    for blk in (jr.demod, jr.af_resamp, jr.deemp):
        if blk is not None:
            jit_methods(blk)
    B = pr.in_multiple * max(1, round(seconds * FS / pr.in_multiple))
    x = _capture(blocks * B)
    jp, pp = jr.make_params(offset), pr.make_params(offset)
    js, ps = jr.init_state(()), pr.init_state(())

    def held(js):
        """The JAX state in the port's layout (the lag's state as the
        port's ``pilot_lag``)."""
        if not lag_pll:
            return js
        d = js["demod"]
        return dict(js, demod=dict(d, pll=d["pll"]["pll"],
                                   pilot_lag=d["pll"]["lag"]))
    assert_state_close(held(js), ps, MIN_DB)
    for b in range(blocks):
        xb = x[b * B:(b + 1) * B]
        ja, js = jr.apply(jp, js, jnp.asarray(xb))
        pa, ps = pr.apply(pp, ps, torch.from_numpy(xb))
        assert float(np.mean(np.asarray(ja) ** 2)) > 1e-6
        assert_close(ja, pa, f"audio {b}")
        assert_state_close(held(js), ps, MIN_DB)
    return pr, ps, pa


class _LaggedPLL:
    """The JAX package's PLL with its VCO delayed one sample by the JAX
    package's own ``Delay(1)`` (the lag its normalize route applies), the
    delay's state beside the PLL's: the port's scan route.  The JAX scan
    route leaves the VCO a sample early (ops/wfm.py:186 there), which at
    the 125 kHz MPX rate turns the 38 kHz carrier by 1.91 rad."""

    def __init__(self, dem):
        self.pll, self.lag = dem.pll, dem.pilot_lag

    def init_state(self, batch_shape=()):
        return {"pll": self.pll.init_state(batch_shape),
                "lag": self.lag.init_state(batch_shape, jnp.complex64)}

    def apply(self, params, state, x):
        vco, st = self.pll.apply(params, state["pll"], x)
        vco, lag = self.lag.apply(None, state["lag"], vco)
        return vco, {"pll": st, "lag": lag}


class _Unlagged:
    """The port's ``pilot_lag`` taken out: the VCO passes as it is and the
    lag's state stays what it was (the JAX scan route leaves it so)."""

    def __init__(self, lag):
        self.init_state = lag.init_state

    def apply(self, params, state, x):
        return x, state


@pytest.mark.parametrize("form", ["mono", "scan"])
def test_wfm_forms_match_jax(form):
    """Mono, and the scan PLL against the JAX route with the VCO lagged
    one sample (``_LaggedPLL``; the port's ``pilot_lag`` state is that
    lag's), whose stereo separation then holds: L over R >= 20 dB on the
    1 kHz tone in L."""
    kw = {"stereo": False} if form == "mono" else {"pll_mode": "scan"}
    pr, ps, audio = _run(dict(demod_id=DEMOD_WFM, **kw), WFM_OFF,
                         lag_pll=form == "scan")
    assert ("mpx_hist" in ps["demod"]) is False
    assert pr.demod.stereo == (form == "scan")
    if form == "scan":
        assert _separation(audio) >= 20.0


def test_scan_pll_is_the_jax_route_but_for_the_lag():
    """The port's scan route less its one-sample VCO lag against the JAX
    package's scan route as it ships: audio and every state leaf >= 80
    dB, so the lag is the routes' one difference.  The JAX route's
    stereo is then swapped (R louder than L on the tone in L: the VCO a
    sample early), which is why the port lags it."""
    _, _, audio = _run(dict(demod_id=DEMOD_WFM, pll_mode="scan"), WFM_OFF,
                       unlag=True)
    assert _separation(audio) < 0.0


@pytest.mark.parametrize("low_pass", [True, False])
def test_broadcast_fm_low_pass_forms_match_jax(low_pass):
    """BroadcastFM without an integer audio rate: the 15 kHz FIR on the
    stacked L/R at the MPX rate, or nothing (``low_pass=False``)."""
    jb = jit_methods(jax_wfm.BroadcastFM(75e3, 500e3, low_pass=low_pass))
    pb = wfm.BroadcastFM(75e3, 500e3, low_pass=low_pass)
    assert (pb.audio_fir is None) == (not low_pass) and pb.audio_poly is None
    T = 4 * 2500
    x = rds_fm_iq(2 * T, 500e3, seed=2)
    js, ps = jb.init_state(()), pb.init_state(())
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        assert py.shape == (2, T // 4)
        assert_close(jy, py, f"lr {b}")
        assert_state_close(js, ps, MIN_DB)


@pytest.mark.parametrize("kw,offset", [
    (dict(demod_id=DEMOD_WFM, audio_samplerate=32_000.0), WFM_OFF),
    (dict(demod_id=DEMOD_NFM, deemphasis="75us",
          audio_samplerate=400_000.0, seconds=0.02), NFM_OFF),
    (dict(demod_id=DEMOD_NFM, deemphasis="50us"), NFM_OFF),
], ids=["wfm-32k-fir", "nfm-400k-recurrence", "nfm-50us"])
def test_af_resampler_and_deemphasis_match_jax(kw, offset):
    kw = dict(kw)
    pr, ps, _ = _run(kw, offset, seconds=kw.pop("seconds", 0.06))
    assert pr.af_resamp is not None and "deemp" in ps
    assert bool(pr.deemp.fir_k) == (kw.get("audio_samplerate") != 400_000.0)


@pytest.mark.parametrize("tau,fs", [(50e-6, 48_000.0), (75e-6, 1e6)],
                         ids=["fir", "recurrence"])
def test_deemphasis_apply_matches_jax(tau, fs):
    jd = jit_methods(jax_rec.Deemphasis(tau, fs))
    pd = recurrence.Deemphasis(tau, fs)
    assert pd.fir_k == jd.fir_k and bool(pd.fir_k) == (fs == 48_000.0)
    rng = np.random.default_rng(5)
    js, ps = jd.init_state((2,)), pd.init_state((2,))
    for b in range(3):
        x = rng.standard_normal((2, 700)).astype(np.float32)
        jy, js = jd.apply(None, js, jnp.asarray(x))
        py, ps = pd.apply(None, ps, torch.from_numpy(x))
        assert_close(jy, py, f"y {b}")
        assert_close(js, ps, f"state {b}")


def test_raw_matches_jax():
    pr, ps, _ = _run(dict(demod_id=DEMOD_RAW), NFM_OFF)
    assert pr.demod_stereo and ps["demod"] is None and pr.if_rate == 48e3


@pytest.mark.parametrize("low_pass,high_pass", [(False, True), (True, True),
                                                (False, False)],
                         ids=["high-pass", "band-pass", "unfiltered"])
def test_fm_demod_forms_match_jax(low_pass, high_pass):
    kw = dict(low_pass=low_pass, high_pass=high_pass)
    jd = jit_methods(jax_demod.FMDemod(50e3, 12.5e3, **kw))
    pd = demod.FMDemod(50e3, 12.5e3, **kw)
    n = np.arange(3 * 2000)
    tone = 0.8 * np.sin(2 * np.pi * 700.0 * n / 50e3) + 0.5
    x = np.stack([np.exp(2j * np.pi * (2500.0 + 300 * k) * np.cumsum(tone)
                         / 50e3) for k in range(3)]).astype(np.complex64)
    js, ps = jd.init_state((3,)), pd.init_state((3,))
    for b in range(3):
        xb = x[:, b * 2000:(b + 1) * 2000]
        jy, js = jd.apply(None, js, jnp.asarray(xb))
        py, ps = pd.apply(None, ps, torch.from_numpy(xb))
        assert_close(jy, py, f"audio {b}")
        assert_state_close(js, ps, MIN_DB)


def _provider(mod):
    """A plugin NFM at a 25 kHz IF, 8 kHz wide (a narrow FM voice
    demod)."""
    def factory(bandwidth, audio_sr):
        return {"block": mod.FMDemod(25_000.0, 8_000.0), "if_rate": 25_000.0,
                "bandwidth": 8_000.0}
    return factory


@pytest.fixture
def provider():
    """'NARROWFM' registered in both packages, and taken out after."""
    jax_radio_mod.register_demod_provider("narrowfm", _provider(jax_demod))
    radio_mod.register_demod_provider("narrowfm", _provider(demod))
    yield "NARROWFM"
    jax_radio_mod.DEMOD_PROVIDERS.pop("NARROWFM")
    radio_mod.DEMOD_PROVIDERS.pop("NARROWFM")


def test_provider_radio_matches_jax(provider):
    assert radio_mod.list_demods() == jax_radio_mod.list_demods()
    assert radio_mod.list_demods()[-1] == provider
    pr, ps, _ = _run(dict(demod_id="narrowfm"), NFM_OFF)
    assert pr.demod_id is None and pr.demod_name == provider
    assert pr.bandwidth == 8_000.0 and "deemp" not in ps


def test_provider_through_the_app(provider, tmp_path):
    """set_demod to the provider's name, get_demod, list_demods and back:
    the JAX app's answers, and the radio steps."""
    answers = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        os.makedirs(root)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({"source": {"type": "none", "samplerate": FS},
                       "modules": {"R": {"type": "radio", "demod": "NFM",
                                         "offset": NFM_OFF}}}, f)
        with pytest.MonkeyPatch.context() as mp:
            if side == "jax":
                mp.setattr(jax, "jit", lambda f, *a, **k: f)
                app = JaxApp(root, run_pump=False)
            else:
                app = SDRApp(root, run_pump=False, device="cpu")
            m = app.modules["R"]
            got = [m.handle_debug_command(c, a) for c, a in (
                ("set_demod", provider.lower()), ("get_demod", ""),
                ("list_demods", ""), ("get_vfo_bandwidth", ""))]
            x = _capture(m.radio.in_multiple * 4)
            y, _ = (m.radio.apply(m.params, m.state, torch.from_numpy(x))
                    if side == "port" else
                    m.jit_step(m.params, m.state, jnp.asarray(x)))
            got.append(np.asarray(y))
            got.append(m.handle_debug_command("set_demod", "NFM"))
            app.shutdown()
        answers[side] = got
    j, p = answers["jax"], answers["port"]
    assert p[0] == {"status": "ok", "demod": provider, "id": -1}
    assert p[:4] == j[:4] and p[5] == j[5]
    assert {"name": provider, "id": -1} in p[2]["demods"]
    assert_close(j[4], p[4], "provider audio")


def test_wfm_squelch_apply_shared_matches_jax():
    """Two VFOs, the station and the NFM carrier's empty neighbourhood,
    the squelch at −30 dB: the station open, the other exactly silent."""
    offs = [WFM_OFF, -350e3]
    jr = jit_methods(JaxRadio(FS, DEMOD_WFM, squelch_enabled=True),
                     "apply_shared")
    pr = Radio(FS, DEMOD_WFM, squelch_enabled=True, device="cpu")
    jp = jr.make_params_shared(offs, squelch_level=-30.0)
    pp = pr.make_params_shared(offs, squelch_level=-30.0)
    js, ps = jr.init_state_shared(2), pr.init_state_shared(2)
    B = pr.in_multiple * round(0.06 * FS / pr.in_multiple)
    x = _capture(2 * B, seed=3)
    for b in range(2):
        xb = x[b * B:(b + 1) * B]
        ja, js = jr.apply_shared(jp, js, jnp.asarray(xb))
        pa, ps = pr.apply_shared(pp, ps, planes(xb))
        assert_close(ja, pa, f"audio {b}")
        assert_state_close(js, ps, MIN_DB)
        assert pa[0].abs().max() > 0.1 and not pa[1].any()
