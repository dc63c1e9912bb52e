"""The whole wide-bank NFM scanner slice: the port's
``Radio.apply_channelized`` (plain versions of K5-K7) against the JAX
package's ``apply_channelized(..., _force_fused=True)`` (its Pallas
kernels in interpret mode), C = 8, over three blocks with a retune before
the third, in both handoff dtypes; and the port's device rule.

Bounds.  Float32: audio 70 dB on the open channels from block 2 and
state 80 dB (measured: block 1 127.4 dB, then 128.8 and 129.6 dB; state
≥ 119.9 dB).  Bf16: every handoff rounds float32 values that differ by
float32 noise between the two packages, and a value on the other side of
a bf16 rounding boundary moves by a bf16 ulp (2^-8) — the JAX package's
own two bf16 routes (V3 fused, V2 then post) agree to 54 dB on the IF and
45 dB on the audio.  The bf16 bounds are 45 dB on the audio from block 2
and 35 dB on the state (measured: block 1 43.7 dB, then 57.4 and
60.4 dB; state ≥ 43.2 dB).  Block 1 starts every filter from zero; its
figure is checked at 30 dB."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_NFM
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models import radio as radio_mod
from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

from torch_parity import (FS, assert_state_close, leaves, nfm_iq, planes,
                          port_f32_handoff, snr_db)  # noqa: F401

C = 8
T = 96_000
OFFSETS = np.linspace(-1.1e6, 1.1e6, C) + 917.0
RETUNED = OFFSETS + np.array([0.0, 0.0, 2500.0, 0.0, -1800.0, 0.0, 0.0, 0.0])
TONE_CH = [0, 2, 4, 6]
LEVEL = -30.0


def _radios():
    return (JaxRadio(FS, DEMOD_NFM, squelch_enabled=True,
                     pll_mode="normalize"),
            Radio(FS, DEMOD_NFM, squelch_enabled=True, device="cpu"))


@pytest.mark.parametrize("handoff,audio_db,state_db", [
    ("float32", 70.0, 80.0), ("bf16", 45.0, 35.0)])
def test_apply_channelized_matches_jax(handoff, audio_db, state_db):
    jax_precision.set_handoff_dtype(handoff)
    port_precision.set_handoff_dtype(handoff)
    jr, pr = _radios()
    assert pr.in_multiple == jr.in_multiple == 2400 and pr.can_channelize()
    x = nfm_iq(3 * T, OFFSETS, TONE_CH, seed=11)
    js = jr.init_state_channelized(C)
    ps = pr.init_state_channelized(C)
    for b in range(3):
        offs = OFFSETS if b < 2 else RETUNED
        xb = x[b * T:(b + 1) * T]
        ja, js = jr.apply_channelized(
            jr.make_params_channelized(offs, squelch_level=LEVEL), js,
            (jnp.asarray(xb.real), jnp.asarray(xb.imag)), _force_fused=True)
        pa, ps = pr.apply_channelized(
            pr.make_params_channelized(offs, squelch_level=LEVEL), ps,
            planes(xb))
        ja, pa = np.asarray(ja), pa.numpy()
        assert pa.shape == ja.shape == (C, 2, T // 50)
        open_j = np.abs(ja).max(axis=(1, 2)) > 0
        open_p = np.abs(pa).max(axis=(1, 2)) > 0
        np.testing.assert_array_equal(open_p, open_j)
        np.testing.assert_array_equal(np.flatnonzero(open_p), TONE_CH)
        s = snr_db(ja[open_j], pa[open_p])
        assert s >= (audio_db if b else 30.0), (b, s)
        assert_state_close(js, ps, state_db)


def test_raw_audio_same_samples():
    _, pr = _radios()
    x = nfm_iq(2 * T, OFFSETS, TONE_CH, seed=12)
    params = pr.make_params_channelized(OFFSETS, squelch_level=LEVEL)
    st1 = st2 = pr.init_state_channelized(C)
    for b in range(2):
        xb = planes(x[b * T:(b + 1) * T])
        mono, st1 = pr.apply_channelized(params, st1, xb, mono_out=True)
        (raw, m_aud), st2 = pr.apply_channelized(params, st2, xb,
                                                 raw_audio=True)
        assert m_aud == T // 50 and raw.shape == (C, 3 * 1024)
        assert raw.dtype == port_precision.get_handoff_dtype()
        torch.testing.assert_close(raw[:, :m_aud], mono, rtol=0, atol=0)
        stereo, _ = pr.apply_channelized(params, st1, xb)
        assert stereo.shape == (C, 2, m_aud)
    for (k, a), (_, b) in zip(leaves(st1), leaves(st2)):
        assert torch.equal(a, b), k


def test_squelch_off_opens_every_channel():
    """Without the squelch every channel is demodulated; the open ones
    give the same audio as with it."""
    _, pr = _radios()
    plain = Radio(FS, DEMOD_NFM, device="cpu")
    assert "squelch" not in plain.make_params_channelized(OFFSETS)
    xb = planes(nfm_iq(T, OFFSETS, TONE_CH, seed=13))
    a_off, _ = plain.apply_channelized(plain.make_params_channelized(
        OFFSETS), plain.init_state_channelized(C), xb, mono_out=True)
    a_on, _ = pr.apply_channelized(pr.make_params_channelized(
        OFFSETS, squelch_level=LEVEL), pr.init_state_channelized(C), xb,
        mono_out=True)
    assert (a_off.abs().amax(-1) > 0).all()
    torch.testing.assert_close(a_off[TONE_CH], a_on[TONE_CH], rtol=0,
                               atol=0)


def test_cpu_radio_keeps_params_and_state_on_the_cpu():
    _, pr = _radios()
    params = pr.make_params_channelized(OFFSETS)
    state = pr.init_state_channelized(C)
    for tree in (params, state):
        for k, v in leaves(tree):
            assert v.device.type == "cpu", k
    audio, state = pr.apply_channelized(params, state,
                                        planes(nfm_iq(T, OFFSETS, [1])))
    assert audio.device.type == "cpu"
    for k, v in leaves(state):
        assert v.device.type == "cpu", k
    assert params["vfo"]["bin"].dtype == torch.int32
    assert params["squelch"]["level"].dtype == torch.float32


def test_default_radio_runs_on_cuda_or_raises(monkeypatch):
    """The default device is CUDA; without one the Radio raises at first
    use instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for demod_id in (DEMOD_NFM, DEMOD_WFM):
        r = Radio(FS, demod_id)
        assert r.device == torch.device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            r.init_state((4,))
    r = Radio(FS, DEMOD_NFM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.make_params_channelized(OFFSETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radio(FS, DEMOD_WFM).make_params_shared(OFFSETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        radio_mod.ChannelizedRxVFOBank(FS, 50e3, 12.5e3).apply(
            None, None, planes(nfm_iq(T, OFFSETS, [1])))


def test_unported_paths_raise():
    """What the channelized route still refuses: a demod that cannot
    channelize (WFM: the bank's ValueError, as in the JAX package), raw
    audio beside the noise blanker and the FM IF filter, a block off the
    granularity; another demod that can (AM) runs it
    (tests/test_torch_channelized_modes.py holds them to JAX).  WFM with
    the squelch through apply_shared, the RAW demod and de-emphasis on a
    mono demod build (tests/test_torch_radio_forms.py holds them to
    JAX)."""
    pr = Radio(FS, DEMOD_NFM, device="cpu")
    wfm = Radio(FS, DEMOD_WFM, squelch_enabled=True, device="cpu")
    with pytest.raises(ValueError, match="even integer"):
        wfm.apply_channelized(None, None, planes(nfm_iq(T, OFFSETS, [1])))
    am = Radio(FS, "AM", device="cpu")
    audio, _ = am.apply_channelized(am.make_params_channelized(OFFSETS),
                                    am.init_state_channelized(C),
                                    planes(nfm_iq(T, OFFSETS, [1])))
    assert audio.shape == (C, 2, T // 50) and torch.isfinite(audio).all()
    # the noise blanker and the FM IF filter leave the fused routes
    # (tests/test_torch_noise_chain.py); raw audio has no such route
    nb = Radio(FS, DEMOD_NFM, nb_enabled=True, fmif_enabled=True,
               device="cpu")
    with pytest.raises(NotImplementedError, match="raw_audio"):
        nb.apply_channelized(nb.make_params_channelized(OFFSETS),
                             nb.init_state_channelized(C),
                             planes(nfm_iq(T, OFFSETS, [1])), raw_audio=True)
    assert Radio(FS, "RAW", device="cpu").demod_stereo
    assert "deemp" in Radio(FS, "AM", deemphasis="50us",
                            device="cpu").init_state(())
    with pytest.raises(ValueError):
        pr.apply_channelized(pr.make_params_channelized(OFFSETS),
                             pr.init_state_channelized(C),
                             planes(nfm_iq(T + 48, OFFSETS, [1])))


def test_channelized_layout_and_round_trip():
    jr, pr = _radios()
    for tree in ("params", "state"):
        if tree == "params":
            j = jr.make_params_channelized(OFFSETS, squelch_level=LEVEL)
            p = pr.make_params_channelized(OFFSETS, squelch_level=LEVEL)
        else:
            j = jr.init_state_channelized(C)
            p = pr.init_state_channelized(C)
        jl = list(leaves(j))
        pl = list(leaves(convert.state_to_jax(p)))
        assert [k for k, _ in jl] == [k for k, _ in pl]
        for (k, a), (_, b) in zip(jl, pl):
            a = np.asarray(a)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), k
            np.testing.assert_array_equal(b, a, err_msg=k)
    rng = np.random.default_rng(9)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        a = np.asarray(tree)
        v = rng.standard_normal(a.shape)
        if np.iscomplexobj(a):
            v = v + 1j * rng.standard_normal(a.shape)
        return v.astype(a.dtype)
    st = fill(jr.init_state_channelized(C))
    back = convert.state_to_jax(convert.state_from_jax(st, device="cpu"))
    for (k, a), (_, b) in zip(leaves(st), leaves(back)):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    p = convert.params_from_jax(
        jr.make_params_channelized(OFFSETS, squelch_level=LEVEL),
        device="cpu")
    assert p["vfo"]["bin"].dtype == torch.int32
    for (k, a), (_, b) in zip(leaves(p), leaves(
            pr.make_params_channelized(OFFSETS, squelch_level=LEVEL))):
        assert torch.equal(a, b), k
