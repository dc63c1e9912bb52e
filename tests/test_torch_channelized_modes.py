"""The channelized bank for every demod that can channelize: the port's
``Radio.apply_channelized`` (plain versions of K5 and K6, then the demod's
K12 and K8 and the AF resampler's K8) against the JAX package's
``apply_channelized(..., _force_fused=True)`` (its ``_chz_kernel`` for
AM's M = 160, the XLA PFB for SSB, DSB and CW, then ``_chan_kernel``, in
interpret mode), C = 8, three blocks with a retune before the third, in
both handoff dtypes; a 16-VFO AM ``RadioBank`` with ``"auto"`` against
the JAX bank; and ``SharedRxVFOBank`` without a predecimation stage (NFM
at 96 kS/s) against the JAX ``apply_shared``.

Bounds (``tests/test_torch_scanner.py``'s).  Float32: audio 70 dB from
block 2, state 80 dB; bf16: 45 dB on the audio from block 2, 35 dB on the
state.  Block 1 starts every filter from zero; it is checked at 30 dB.
The AGC does not lower these figures here.  Measured: float32 audio
>= 110.1 dB from block 2 in every mode (block 1 >= 88.1 dB, CW's, whose
1140-tap FIR is still filling); bf16 audio >= 52.3 dB from block 2
(block 1 >= 43.4 dB).  The JAX side runs under ``jax.jit`` (one compile
a configuration, shared through ``_jax_run`` by the tests)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.models import radio_bank as jax_bank
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch.models import radio_bank
from sdrplusplusbrown_tpu_torch.models.radio import (
    DEMOD_AM, DEMOD_CW, DEMOD_DSB, DEMOD_IDS, DEMOD_LSB, DEMOD_NFM,
    DEMOD_USB, Radio)
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

from torch_parity import (FS, assert_state_close, planes,  # noqa: F401
                          port_f32_handoff, snr_db)

C = 8
OFFSETS = np.linspace(-1.1e6, 1.1e6, C) + 917.0
RETUNED = OFFSETS + np.array([0.0, 0.0, 250.0, 0.0, -180.0, 0.0, 0.0, 0.0])
TONE_CH = [0, 2, 4, 6]
#: block length a mode (a multiple of its granularity: AM 3200, SSB and
#: DSB 1600, CW 6400)
BLOCK = {"AM": 19_200, "USB": 19_200, "LSB": 19_200, "DSB": 19_200,
         "CW": 25_600}
BOUNDS = {"float32": (70.0, 80.0), "bf16": (45.0, 35.0)}


def mode_iq(T: int, fs: float, demod: int, offsets, channels,
            seed: int = 0) -> np.ndarray:
    """A 1 kHz audio tone on each channel of ``channels`` in ``demod``'s
    modulation at its offset (AM 30 % depth; USB and LSB the tone's
    sideband of a suppressed carrier 1.4 kHz below or above the offset,
    the passband's centre; DSB both sidebands; CW a carrier on the
    offset), plus complex noise at 1e-3."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    x = 1e-3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    tone = np.sin(2 * np.pi * 1000.0 * t)
    for k in channels:
        f = offsets[k]
        if demod == DEMOD_AM:
            x = x + 0.2 * (1 + 0.3 * tone) * np.exp(2j * np.pi * f * t)
        elif demod == DEMOD_USB:
            x = x + 0.1 * np.exp(2j * np.pi * (f - 400.0) * t)
        elif demod == DEMOD_LSB:
            x = x + 0.1 * np.exp(2j * np.pi * (f + 400.0) * t)
        elif demod == DEMOD_DSB:
            x = x + 0.2 * tone * np.exp(2j * np.pi * f * t)
        else:
            x = x + 0.1 * np.exp(2j * np.pi * f * t)
    return x.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _jax_run(demod: str, handoff: str):
    """The JAX radio's three blocks (one run a configuration, shared by
    the tests that read it): (input, [(audio, state)] a block)."""
    jax_precision.set_handoff_dtype(handoff)
    try:
        d = DEMOD_IDS[demod]
        jr = JaxRadio(FS, d)
        step = jax.jit(functools.partial(jr.apply_channelized,
                                         _force_fused=True))
        T = BLOCK[demod]
        x = mode_iq(3 * T, FS, d, RETUNED, TONE_CH, seed=d)
        js = jr.init_state_channelized(C)
        out = []
        for b in range(3):
            xb = x[b * T:(b + 1) * T]
            ja, js = step(
                jr.make_params_channelized(OFFSETS if b < 2 else RETUNED),
                js, (jnp.asarray(xb.real), jnp.asarray(xb.imag)))
            out.append((np.asarray(ja), js))
    finally:
        jax_precision.set_handoff_dtype("float32")
    return x, out


@pytest.mark.parametrize("handoff", ["float32", "bf16"])
@pytest.mark.parametrize("demod", ["AM", "USB", "LSB", "DSB", "CW"])
def test_apply_channelized_matches_jax(demod, handoff):
    audio_db, state_db = BOUNDS[handoff]
    port_precision.set_handoff_dtype(handoff)
    d = DEMOD_IDS[demod]
    pr = Radio(FS, d, device="cpu")
    T = BLOCK[demod]
    assert pr.can_channelize() and T % pr.in_multiple == 0
    x, jout = _jax_run(demod, handoff)
    ps = pr.init_state_channelized(C)
    for b, (ja, js) in enumerate(jout):
        pa, ps = pr.apply_channelized(
            pr.make_params_channelized(OFFSETS if b < 2 else RETUNED), ps,
            planes(x[b * T:(b + 1) * T]))
        pa = pa.numpy()
        assert pa.shape == ja.shape == (C, 2, T // 50)
        assert np.isfinite(pa).all()
        s = snr_db(ja, pa)
        assert s >= (audio_db if b else 30.0), (demod, b, s)
        assert_state_close(js, ps, state_db)


def test_squelch_gates_from_the_post_channelizer_sums():
    """AM with the squelch: a channel off every carrier gives exact
    zeros, one on a carrier the same audio as without the squelch (the
    gate, from K6's Σ|IF|, multiplies by exactly 1)."""
    sq = Radio(FS, DEMOD_AM, squelch_enabled=True, device="cpu")
    plain = Radio(FS, DEMOD_AM, device="cpu")
    T = BLOCK["AM"]
    xb = planes(mode_iq(T, FS, DEMOD_AM, OFFSETS, TONE_CH, seed=3))
    a_sq, _ = sq.apply_channelized(
        sq.make_params_channelized(OFFSETS, squelch_level=-30.0),
        sq.init_state_channelized(C), xb, mono_out=True)
    a, _ = plain.apply_channelized(plain.make_params_channelized(OFFSETS),
                                   plain.init_state_channelized(C), xb,
                                   mono_out=True)
    assert a_sq.shape == (C, T // 50)
    closed = [c for c in range(C) if c not in TONE_CH]
    assert not a_sq[closed].any() and a[closed].any()
    assert torch.equal(a_sq[TONE_CH], a[TONE_CH])


def test_wfm_and_raw_cannot_channelize():
    """WFM and RAW raise the bank's ValueError, as the JAX package's do;
    raw audio is NFM's alone."""
    for d in ("WFM", "RAW"):
        r = Radio(FS, d, device="cpu")
        assert not r.can_channelize()
        with pytest.raises(ValueError):
            r.make_params_channelized(OFFSETS)
        with pytest.raises(ValueError):
            JaxRadio(FS, DEMOD_IDS[d]).make_params_channelized(OFFSETS)
    am = Radio(FS, DEMOD_AM, device="cpu")
    with pytest.raises(NotImplementedError, match="raw_audio"):
        am.apply_channelized(am.make_params_channelized(OFFSETS),
                             am.init_state_channelized(C),
                             planes(mode_iq(BLOCK["AM"], FS, DEMOD_AM,
                                            OFFSETS, [0])), raw_audio=True)


def test_am_bank_auto_channelizes_and_matches_jax():
    """A RadioBank of 16 AM VFOs with ``"auto"`` channelizes the group
    (CHANNELIZE_MIN_C) on both sides; two blocks of its audio against the
    JAX bank's (its radio on the fused route) in float32: 30 dB on block
    1, 70 dB on block 2; state 80 dB."""
    n = radio_bank.CHANNELIZE_MIN_C
    offs = np.linspace(-1.0e6, 1.0e6, n) + 517.0
    pb = radio_bank.RadioBank(FS, [radio_bank.VFOSpec(f"a{i}", DEMOD_AM, o)
                                   for i, o in enumerate(offs)],
                              device="cpu")
    jb = jax_bank.RadioBank(FS, [jax_bank.VFOSpec(f"a{i}", DEMOD_AM, o)
                                 for i, o in enumerate(offs)])
    assert pb.channelized == jb.channelized == {DEMOD_AM: True}
    jr = jb.radios[DEMOD_AM]
    jr.apply_channelized = functools.partial(type(jr).apply_channelized, jr,
                                             _force_fused=True)
    step = jax.jit(functools.partial(jb.apply, mono_out=True))
    T = 2 * pb.in_multiple
    assert T == 6400 and pb.in_multiple == jb.in_multiple
    x = mode_iq(2 * T, FS, DEMOD_AM, offs, range(0, n, 2), seed=5)
    ps, js = pb.init_state(), jb.init_state()
    pp, jp = pb.make_params(), jb.make_params()
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        pa, ps = pb.apply(pp, ps, torch.from_numpy(xb), mono_out=True)
        ja, js = step(jp, js, jnp.asarray(xb))
        assert pa[DEMOD_AM].shape == (n, T // 50)
        s = snr_db(np.asarray(ja[DEMOD_AM]), pa[DEMOD_AM].numpy())
        assert s >= (70.0 if b else 30.0), (b, s)
        assert_state_close(js[DEMOD_AM], ps[DEMOD_AM], 80.0)


def test_shared_bank_without_predecimation_matches_jax():
    """NFM at 96 kS/s: the chain is the polyphase resampler alone, so the
    shared bank broadcasts the wideband to a translator a channel (the
    "xlate" route; on the card the stages run on K8, then K7) against the
    JAX ``apply_shared`` (its broadcast fallback, then its demod + audio
    kernel in interpret mode), 4 VFOs, three 0.1 s blocks with a retune
    before the third: audio >= 80 dB (measured 87.4, 94.4 and 93.6 dB),
    state >= 80 dB; the tone channels' audio carries the tone.  The JAX
    side runs op by op: under ``jax.jit`` XLA's fused multiply-add moves
    the translator's phase by a rounding, across the 2π wrap."""
    fs = 96e3
    offs = np.array([-30e3, -10e3, 12e3, 33e3])
    jr, pr = JaxRadio(fs, DEMOD_NFM), Radio(fs, DEMOD_NFM, device="cpu")
    vs = pr._build_vfo_shared()
    assert vs.route == "xlate" and not vs.has_predec
    assert jr._build_vfo_shared().fused is None
    T = 9600
    assert T % pr.in_multiple == 0
    t = np.arange(3 * T) / fs
    tone = np.sin(2 * np.pi * 1000.0 * t)
    x = 1e-3 * (np.random.default_rng(2).standard_normal((3 * T, 2))
                @ np.array([1.0, 1j]))
    for o in offs[[0, 2]]:
        x = x + 0.2 * np.exp(1j * (2 * np.pi * o * t
                                   + 2 * np.pi * 2000.0 * np.cumsum(tone)
                                   / fs))
    x = x.astype(np.complex64)
    js, ps = jr.init_state_shared(4), pr.init_state_shared(4)
    for b in range(3):
        o = offs if b < 2 else offs + np.array([0.0, 300.0, 0.0, -200.0])
        xb = x[b * T:(b + 1) * T]
        ja, js = jr.apply_shared(jr.make_params_shared(o), js,
                                 jnp.asarray(xb), _force_fused=True)
        pa, ps = pr.apply_shared(pr.make_params_shared(o), ps,
                                 torch.from_numpy(xb))
        ja, pa = np.asarray(ja), pa.numpy()
        assert pa.shape == ja.shape == (4, 2, T // 2)
        assert snr_db(ja, pa) >= 80.0, (b, snr_db(ja, pa))
        assert_state_close(js, ps, 80.0)
    a = pa[0, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    assert np.argmax(spec[5:]) + 5 == round(1000.0 * a.size / 48e3)
