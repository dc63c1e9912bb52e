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


def _post_case(demod, seed):
    """(ChanPostPipeline, params, state, C, Tb) of ``demod``'s channelized
    bank at 2.4 MS/s, C = 8 channels (two on one bin) and 0.1 s."""
    bank = Radio(FS, demod, device="cpu")._build_vfo_channelized()
    _, post = bank.pipes()
    offs = OFFSETS.copy()
    offs[3] = offs[2] + 1.0                  # a duplicate bin
    params = bank.make_params(offs)
    st = bank.init_state(C)
    rng = np.random.default_rng(seed)
    for k in ("d2", "fir"):                  # nonzero carried tails
        st[k] = torch.from_numpy((1e-2 * (rng.standard_normal(
            st[k].shape) + 1j * rng.standard_normal(st[k].shape))).astype(
                np.complex64))
    return bank, post, params, st, 2 * 240_000 // bank.M


def _post_args(post, params, st, bins, bin_idx, Tb, dtype):
    from sdrplusplusbrown_tpu_torch.ops.chan_frontend import BS, SPAN
    om = params["xl"]["omega"]
    a_sup, rem = divmod(post.adv0, SPAN)
    span = params["xl_sup"] * a_sup + params["xl_bs"] * (rem // BS)
    tails = [torch.cat([st[n].real, st[n].imag]).float().contiguous()
             for n in post.names]
    return (post, bins, bin_idx, om, st["xl"], span, params["xl_bs"],
            tails, Tb, dtype, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("demod", [DEMOD_AM, DEMOD_USB, DEMOD_CW])
def test_post_on_the_gathered_rows_equals_the_full_plane(demod, dtype):
    """K6's plain version on the compact plane pair [2C, Tb_pad] (rows
    [bin | M + bin] of the full plane) with the bin index 0 .. C − 1
    equals its result on the full [2M, Tb_pad] plane with the channels'
    bins, bit for bit: the IF, the squelch sums and both tails."""
    from sdrplusplusbrown_tpu_torch.ops.chan_frontend import chan_post_ref
    bank, post, params, st, Tb = _post_case(demod, 3)
    M, W = bank.M, post.plan(Tb)["Tb_pad"]
    rng = np.random.default_rng(4)
    full = torch.from_numpy(rng.standard_normal((2 * M, W)).astype(
        np.float32)).to(dtype)
    b = params["bin"]
    compact = full[torch.cat([b, b + M]).long()]
    want = chan_post_ref(*_post_args(post, params, st, full, b, Tb, dtype))
    got = chan_post_ref(*_post_args(post, params, st, compact,
                                    torch.arange(C, dtype=torch.int32), Tb,
                                    dtype))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, w) for a, w in zip(got[2], want[2]))


@pytest.mark.parametrize("demod", [DEMOD_AM, DEMOD_USB, DEMOD_CW])
def test_post_ignores_the_bins_past_the_valid_frames(demod):
    """The large-M kernel leaves the columns past its valid tiles
    unwritten: K6's valid IF (the first m_if outputs), its squelch sums
    and both tails are bit for bit the same when the bins past Tb hold
    NaN."""
    from sdrplusplusbrown_tpu_torch.ops.chan_frontend import chan_post_ref
    bank, post, params, st, Tb = _post_case(demod, 5)
    W = post.plan(Tb)["Tb_pad"]
    assert W > Tb
    rng = np.random.default_rng(6)
    bins = torch.from_numpy(rng.standard_normal((2 * C, W)).astype(
        np.float32))
    nan = bins.clone()
    nan[:, Tb:] = float("nan")
    idx = torch.arange(C, dtype=torch.int32)
    m = post.plan(Tb)["m"][-1]
    want = chan_post_ref(*_post_args(post, params, st, bins, idx, Tb,
                                     torch.float32))
    got = chan_post_ref(*_post_args(post, params, st, nan, idx, Tb,
                                    torch.float32))
    assert torch.equal(got[0][:, :m], want[0][:, :m])
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(a, w) for a, w in zip(got[2], want[2]))


def test_bank_gathers_only_above_m64_and_under_m_channels():
    """``ChannelizedRxVFOBank.apply`` asks K5 for the 2C rows [bin |
    M + bin] above M = 64 with fewer channels than bins, the whole plane
    otherwise (the scanner's M = 48; C >= M); the row list is made once
    for a bin tensor and made anew for a retune's."""
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    am = Radio(FS, DEMOD_AM, device="cpu")._build_vfo_channelized()
    nfm = Radio(FS, DEMOD_NFM, device="cpu")._build_vfo_channelized()
    assert am.gathers(C) and not am.gathers(am.M) and not nfm.gathers(C)
    seen = []
    orig = ck.pfb_bins

    def spy(*a):
        seen.append(a[8])
        return orig(*a)
    x = planes(mode_iq(am.M * 40, FS, DEMOD_AM, OFFSETS, TONE_CH))
    ck.pfb_bins = spy
    try:
        p = am.make_params(OFFSETS)
        st = am.init_state(C)
        for params in (p, p, am.make_params(RETUNED)):
            _, _, st = am.apply(params, st, x)
    finally:
        ck.pfb_bins = orig
    assert seen[0] is seen[1] and seen[2] is not seen[1]
    for params, rows in zip((p, p, am.make_params(RETUNED)), seen):
        b = params["bin"]
        assert rows.dtype == torch.int32
        assert rows.tolist() == b.tolist() + (b + am.M).tolist()
