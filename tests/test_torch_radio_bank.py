"""The multi-mode bank: the port's ``RadioBank.apply`` against the JAX
package's on the multimode8 VFO list (4 NFM, 2 AM, 2 USB; bench.py's
BASELINE config 2) plus one CW VFO, on modulated carriers, at 2.4 and
10 MS/s, three blocks of the bank's smallest length with a retune before
the third (float32 handoff).

The reference takes, per group, the JAX route the port's route matches.
Where the port takes K1 (every group but CW at 2.4 MS/s) the JAX mono
kernel runs in interpret mode: NFM through ``apply_shared(...,
_force_fused=True)`` (K7's body after it), AM and USB through
``SharedRxVFOBank.apply(..., _force_kernel=True)`` and then the radio's
``_post_vfo``.  Where the port takes K11 and K8 (every group at 10 MS/s,
CW at 2.4 MS/s) the JAX CPU route runs the same stages one by one (NFM
then K7's body).  Audio and every state leaf agree to >= 80 dB.
Agreement is measured against the larger of the reference's power and
1e-10: at these lengths the CW chain's output is still its filters'
start-up transient, ~1e-15, whose only content is rounding, so
``test_bank_cw_group_after_the_filter_delay`` holds the CW group's audio
over 0.3 s, where it carries the carrier's tone.

Block 0 starts every filter from zero state.  While the NFM channels'
IF rises out of the chain's transient, under out-of-channel carriers the
filters reject by cancellation, its float32 rounding is large against the
IF itself and the discriminator turns that into audio: there the JAX
package's own kernel and CPU routes agree to only 65.4 dB (2.4 MS/s) and
36.8 dB (10 MS/s) on this signal, so the NFM audio bound in block 0 is
40 dB (measured 44.9 and 78.1 dB, port against the JAX kernel route)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models import radio_bank as jax_bank
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models import radio_bank
from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM, DEMOD_CW,
                                                     DEMOD_NFM, DEMOD_USB,
                                                     DEMOD_WFM)
from sdrplusplusbrown_tpu_torch.ops import precision

from torch_parity import leaves, multimode_iq, planes, \
    port_f32_handoff, snr_db  # noqa: F401

MIN_DB = 80.0
NFM_BLOCK0_DB = 40.0
FLOOR = 1e-10
# the least mean audio power of a block whose agreement the floor must
# not set: the tone of a carrier is ~1e-3 and more
SIGNAL_POWER = 1e-5
# the retune moves each VFO onto a second carrier: NFM and AM past their
# channel filters (two FM carriers in one channel beat through zero, where
# the discriminator's angle is ill-conditioned), USB and CW within theirs
RETUNE = {DEMOD_NFM: 20e3, DEMOD_AM: 15e3, DEMOD_USB: -500.0,
          DEMOD_CW: 50.0}


def _vfos(mod, shift=False):
    """multimode8's VFOs plus cw0 as ``mod``'s VFOSpecs; with ``shift``
    each moved by its mode's RETUNE."""
    vfos = radio_bank.multimode8_vfos() + [
        radio_bank.VFOSpec("cw0", DEMOD_CW, -150e3)]
    return [mod.VFOSpec(v.name, v.demod_id, v.offset_hz
                        + (RETUNE[v.demod_id] if shift else 0.0))
            for v in vfos]


def _agree(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(max(np.mean(ref ** 2), FLOOR)
                               / max(np.mean(err ** 2), 1e-300)))


def _states_agree(js, ps, min_db):
    jl = list(leaves(js))
    pl = list(leaves(convert.state_to_jax(ps)))
    assert [k for k, _ in jl] == [k for k, _ in pl]
    for (k, a), (_, b) in zip(jl, pl):
        a = np.asarray(a)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif np.iscomplexobj(a):
            assert _agree(np.stack([a.real, a.imag]),
                          np.stack([b.real, b.imag])) >= min_db, k
        else:
            assert _agree(a, b) >= min_db, k


def _jax_step(bank, params, state, x, k1_groups):
    """The JAX bank's step on the port's routes: NFM through its kernels
    (the mono kernel where it takes the chain, then K7's body); the mono
    demods of ``k1_groups`` through the mono kernel and ``_post_vfo``;
    every other group through the JAX CPU route."""
    outs, new = {}, {}
    for d, r in bank.radios.items():
        if d in k1_groups and d != DEMOD_NFM:
            st = dict(state[d])
            y, st["vfo"] = r._build_vfo_shared().apply(
                params[d]["vfo"], state[d]["vfo"], x, _force_kernel=True)
            y, new[d] = r._post_vfo(params[d], state[d], st, y,
                                    mono_out=True)
        else:
            kw = {"_force_fused": True} if d == DEMOD_NFM else {}
            y, new[d] = r.apply_shared(params[d], state[d], x,
                                       mono_out=True, **kw)
        outs[d] = np.asarray(y)[:len(bank.groups[d])]
    return outs, new


@pytest.mark.parametrize("fs", [2.4e6, 10e6])
def test_bank_matches_jax(fs):
    jb, pb = jax_bank.RadioBank(fs, _vfos(jax_bank)), \
        radio_bank.RadioBank(fs, _vfos(radio_bank), device="cpu")
    jb2, pb2 = jax_bank.RadioBank(fs, _vfos(jax_bank, True)), \
        radio_bank.RadioBank(fs, _vfos(radio_bank, True), device="cpu")
    T = pb.in_multiple
    assert T == jb.in_multiple == (19_200 if fs < 3e6 else 80_000)
    routes = {d: r._build_vfo_shared().route for d, r in pb.radios.items()}
    assert routes == ({d: "K11" for d in routes} if fs > 3e6 else
                      {DEMOD_NFM: "K1", DEMOD_AM: "K1", DEMOD_USB: "K1",
                       DEMOD_CW: "K11"})
    k1_groups = {d for d, r in routes.items() if r == "K1"}
    x = multimode_iq(3 * T, fs, [(v.demod_id, v.offset_hz)
                                 for v in _vfos(jax_bank) + _vfos(jax_bank,
                                                                  True)])
    js, ps = jb.init_state(), pb.init_state()
    for b in range(3):
        J, P = (jb, pb) if b < 2 else (jb2, pb2)
        xb = x[b * T:(b + 1) * T]
        jp, pp = J.make_params(), P.make_params()
        jo, js = _jax_step(J, jp, js, jnp.asarray(xb), k1_groups)
        po, ps = P.apply(pp, ps, torch.from_numpy(xb), mono_out=True)
        assert set(po) == set(jo)
        for d in jo:
            assert po[d].shape == jo[d].shape == (len(J.groups[d]),
                                                  T * 48_000 // int(fs))
            assert torch.isfinite(po[d]).all()
            if b == 2 and d != DEMOD_CW:
                assert np.mean(jo[d].astype(np.float64) ** 2) >= SIGNAL_POWER
            bound = NFM_BLOCK0_DB if b == 0 and d == DEMOD_NFM else MIN_DB
            assert _agree(jo[d], po[d].numpy()) >= bound, (b, d)
            _states_agree(js[d], ps[d], MIN_DB)


@pytest.mark.parametrize("fs", [2.4e6, 10e6])
def test_bank_cw_group_after_the_filter_delay(fs):
    """A CW group (one VFO, padded to 4 channels) through the bank for
    0.3 s in three blocks, retuned by 50 Hz before the third, against the
    JAX bank's CPU route (the port's K11 + K8 route at both rates): the
    chain's filters delay its IF by ~0.2 s, so the third block's audio
    carries the carrier's tone, and it agrees to >= 80 dB, as does every
    state leaf in every block."""
    vf = [(DEMOD_CW, -150e3), (DEMOD_CW, -150e3 + RETUNE[DEMOD_CW])]
    banks = [(jax_bank.RadioBank(fs, [jax_bank.VFOSpec("cw0", d, o)]),
              radio_bank.RadioBank(fs, [radio_bank.VFOSpec("cw0", d, o)],
                                   device="cpu")) for d, o in vf]
    assert banks[0][1].radios[DEMOD_CW]._build_vfo_shared().route == "K11"
    g = banks[0][1].in_multiple
    T = -(-int(fs * 0.1) // g) * g
    x = multimode_iq(3 * T, fs, vf)
    js, ps = banks[0][0].init_state(), banks[0][1].init_state()
    for b in range(3):
        J, P = banks[b // 2]
        xb = x[b * T:(b + 1) * T]
        jo, js = J.apply(J.make_params(), js, jnp.asarray(xb),
                         mono_out=True)
        po, ps = P.apply(P.make_params(), ps, torch.from_numpy(xb),
                         mono_out=True)
        ref = np.asarray(jo[DEMOD_CW])
        assert po[DEMOD_CW].shape == ref.shape == (1, T * 48_000 // int(fs))
        if b == 2:
            assert np.mean(ref.astype(np.float64) ** 2) >= SIGNAL_POWER
        assert _agree(ref, po[DEMOD_CW].numpy()) >= MIN_DB, b
        _states_agree(js[DEMOD_CW], ps[DEMOD_CW], MIN_DB)


def test_k1_float32_if_for_mono_demods():
    """A mono demod's IF from K1 is float32 even with the bf16 handoff
    (the JAX kernel rounds only its raw buffer): one AM block against the
    JAX mono kernel in interpret mode, both with the bf16 handoff."""
    from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
    from sdrplusplusbrown_tpu_torch.models.radio import Radio
    prev = jax_precision.get_handoff_name()
    jax_precision.set_handoff_dtype("bf16")
    precision.set_handoff_dtype("bf16")
    try:
        jr, pr = JaxRadio(2.4e6, DEMOD_AM), Radio(2.4e6, DEMOD_AM,
                                                  device="cpu")
        offs = np.array([-5e5, 3e5, 5e5, 9e5])
        T = 9_600
        x = multimode_iq(T, 2.4e6, [(DEMOD_AM, o) for o in offs], seed=4)
        jvs, pvs = jr._build_vfo_shared(), pr._build_vfo_shared()
        jy, js = jvs.apply(jr.make_params_shared(offs)["vfo"],
                           jvs.init_state(4), jnp.asarray(x),
                           _force_kernel=True)
        py, ps = pvs.apply(pr.make_params_shared(offs)["vfo"],
                           pvs.init_state(4), planes(x), raw=False)
        raw, _ = pvs.apply(pr.make_params_shared(offs)["vfo"],
                           pvs.init_state(4), planes(x))
    finally:
        jax_precision.set_handoff_dtype(prev)
    assert pvs.route == "K1" and raw.dtype == torch.bfloat16
    assert py.dtype == torch.complex64 and np.asarray(jy).dtype == np.complex64
    assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB
    for k, a in leaves(js):
        b = dict(leaves(convert.state_to_jax(ps)))[k]
        if np.any(np.asarray(a)):
            assert snr_db(np.asarray(a), b) >= MIN_DB, k


def test_padding_mono_out_and_state_layout():
    """Groups of 1-3 VFOs run padded to 4 channels and come out sliced;
    ``mono_out`` drops only a mono demod's duplicate (a WFM group stays
    [C, 2, T]); the params and state trees are the JAX package's, keys,
    shapes and dtypes, and convert round-trips them."""
    fs = 2.4e6
    vfos = [(DEMOD_WFM, -6e5), (DEMOD_NFM, 2e5), (DEMOD_NFM, 4e5),
            (DEMOD_AM, 7e5)]
    pb = radio_bank.RadioBank(fs, [radio_bank.VFOSpec(f"v{i}", d, o)
                                   for i, (d, o) in enumerate(vfos)],
                              device="cpu")
    jb = jax_bank.RadioBank(fs, [jax_bank.VFOSpec(f"v{i}", d, o)
                                 for i, (d, o) in enumerate(vfos)])
    assert pb.vfo_names() == jb.vfo_names() == [
        ("v0", DEMOD_WFM, 0), ("v1", DEMOD_NFM, 0), ("v2", DEMOD_NFM, 1),
        ("v3", DEMOD_AM, 0)]
    assert pb.in_multiple == jb.in_multiple
    for pt, jt in ((pb.init_state(), jb.init_state()),
                   (pb.make_params(), jb.make_params())):
        pl = list(leaves(convert.state_to_jax(pt)))
        jl = list(leaves(jt))
        assert [k for k, _ in pl] == [k for k, _ in jl]
        for (k, a), (_, b) in zip(pl, jl):
            b = np.asarray(b)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), k
            np.testing.assert_array_equal(a, b, err_msg=k)
    st = convert.state_from_jax(jb.init_state(), device="cpu")
    assert st[DEMOD_NFM]["vfo"]["fused"]["phase"].shape == (4,)
    T = pb.in_multiple
    x = torch.from_numpy(multimode_iq(T, fs, vfos))
    for mono in (False, True):
        out, _ = pb.apply(pb.make_params(), st, x, mono_out=mono)
        assert out[DEMOD_WFM].shape == (1, 2, T // 50)
        for d, c in ((DEMOD_NFM, 2), (DEMOD_AM, 1)):
            assert out[d].shape == ((c, T // 50) if mono
                                    else (c, 2, T // 50)), d
    with pytest.raises(ValueError):
        pb.apply(pb.make_params(), st, x[:T - 8])


def test_channelized_groups():
    """A group of CHANNELIZE_MIN_C or more whose mode can channelize takes
    the PFB path with ``"auto"`` (NFM and AM here), a single USB VFO with
    ``channelize=True``; WFM cannot and raises when the bank is built
    (tests/test_torch_channelized_modes.py holds the modes to JAX)."""
    fs = 2.4e6
    offs = np.linspace(-1e6, 1e6, radio_bank.CHANNELIZE_MIN_C)
    with pytest.raises(ValueError):
        radio_bank.RadioBank(fs, [radio_bank.VFOSpec("w", DEMOD_WFM, 0.0)],
                             channelize=True, device="cpu")
    for d, vfos in (
            (DEMOD_AM, [radio_bank.VFOSpec(f"a{i}", DEMOD_AM, o)
                        for i, o in enumerate(offs)]),
            (DEMOD_USB, [radio_bank.VFOSpec("u", DEMOD_USB, 1e5)]),
            (DEMOD_NFM, [radio_bank.VFOSpec(f"n{i}", DEMOD_NFM, o)
                         for i, o in enumerate(offs)])):
        pb = radio_bank.RadioBank(fs, vfos, device="cpu",
                                  channelize=True if d == DEMOD_USB
                                  else "auto")
        assert pb.channelized == {d: True}
        T = pb.in_multiple
        out, st = pb.apply(pb.make_params(), pb.init_state(),
                           torch.from_numpy(multimode_iq(
                               T, fs, [(d, v.offset_hz) for v in vfos])),
                           mono_out=True)
        assert out[d].shape == (len(vfos), T // 50)
        assert torch.isfinite(out[d]).all() and out[d].any()
        assert "chz" in st[d]["vfo"]


def test_bank_device_rule():
    """A default bank runs on the card: without one it raises at first
    use."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pb = radio_bank.RadioBank(2.4e6, _vfos(radio_bank))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.init_state()


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("demod", ["AM", "USB", "LSB", "DSB", "CW"])
def test_radio_apply_mono_demods_match_jax(demod, batch):
    """One radio's step (``Radio.apply``, the app's path) for each new
    demod against the JAX ``Radio.apply`` op by op: three blocks with a
    retune before the third, audio and every state leaf >= 80 dB.  CW
    runs 0.1 s blocks, so that its third block's audio is past its
    filters' delay; every third block's audio carries a real signal."""
    from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_IDS, Radio
    jr, pr = JaxRadio(2.4e6, demod), Radio(2.4e6, demod, device="cpu")
    T = 243_200 if demod == "CW" else 19_200
    assert T % pr.in_multiple == 0 and pr.in_multiple == jr.in_multiple
    offs = np.array([-4e5, 1e5, 6e5])[:batch[0] if batch else 1]
    d = DEMOD_IDS[demod]
    x = multimode_iq(3 * T, 2.4e6, [(d, o) for o in np.concatenate(
        [offs, offs + 700.0])], seed=len(demod))
    js, ps = jr.init_state(batch), pr.init_state(batch)
    for b in range(3):
        o = offs if b < 2 else offs + 700.0
        o = o if batch else float(o[0])
        xb = x[b * T:(b + 1) * T]
        ja, js = jr.apply(jr.make_params(o), js, jnp.asarray(xb))
        pa, ps = pr.apply(pr.make_params(o), ps, torch.from_numpy(xb))
        assert pa.shape == np.asarray(ja).shape == batch + (2, T // 50)
        if b == 2:
            assert np.mean(np.asarray(ja, np.float64) ** 2) >= SIGNAL_POWER
        assert _agree(np.asarray(ja), pa.numpy()) >= MIN_DB, b
        _states_agree(js, ps, MIN_DB)


def test_nfm_squelch_through_apply_shared():
    """NFM with the squelch through ``apply_shared``: a channel off the
    signal at −30 dB gives exact zeros, and a channel on it the same audio
    as without the squelch (K7's gate multiplies by exactly 1)."""
    from sdrplusplusbrown_tpu_torch.models.radio import Radio
    fs, offs = 2.4e6, np.array([-3e5, 2e5, 2e5, 2e5])
    sq = Radio(fs, DEMOD_NFM, squelch_enabled=True, device="cpu")
    plain = Radio(fs, DEMOD_NFM, device="cpu")
    T = sq.in_multiple * 8
    x = planes(multimode_iq(2 * T, fs, [(DEMOD_NFM, 2e5)]))
    s1, s2 = sq.init_state_shared(4), plain.init_state_shared(4)
    for b in range(2):
        xb = tuple(t[b * T:(b + 1) * T] for t in x)
        a1, s1 = sq.apply_shared(sq.make_params_shared(
            offs, squelch_level=-30.0), s1, xb)
        a2, s2 = plain.apply_shared(plain.make_params_shared(offs), s2, xb)
        assert a1.shape == (4, 2, T // 50)
        assert not a1[0].any() and a2[0].any()
        assert torch.equal(a1[1:], a2[1:])


def test_nfm_squelch_bf16_matches_jax_route():
    """Squelched NFM through ``apply_shared`` in the production bf16
    handoff against the JAX route it matches: with the squelch on the JAX
    radio takes the float32 IF (the mono kernel's trimmed output, here in
    interpret mode) through ``_post_vfo`` (Squelch, FMDemod, the AF
    resampler), so the port's gate and K7 read K1's float32 IF, not its
    bf16 buffer, and K7 keeps float32 taps and tails.  Four 8 ms blocks:
    channel 0 sits off the carriers and its gate stays closed (its audio
    exact zeros on both sides), channels 1-3 sit on NFM carriers and open.
    Audio and every state leaf >= 80 dB, but for the cold-start block 0's
    audio: there the IF rises out of the filters' transient, two
    discriminators (FMDemod's XLA atan2 and complex multiply, K7's minimax
    atan2) turn its rounding into different audio (7 dB over the block),
    so only its last quarter is held, at 40 dB as in
    ``test_bank_matches_jax`` (measured 69.7 dB).  Measured after the
    repair: IF 132 dB, audio 128 dB in blocks 1-3, state >= 111.9 dB;
    before it the port demodulated the bf16 buffer (IF 56 dB) with bf16
    taps and tails: audio 51.4-52.9 dB, the demod's FIR tail 43.4 dB."""
    from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
    from sdrplusplusbrown_tpu_torch.models.radio import Radio
    fs, lvl = 2.4e6, -30.0
    offs = np.array([-3e5, 2e5, 4e5, 7e5])
    jr = JaxRadio(fs, DEMOD_NFM, squelch_enabled=True)
    pr = Radio(fs, DEMOD_NFM, squelch_enabled=True, device="cpu")
    T = pr.in_multiple * 8
    x = multimode_iq(4 * T, fs, [(DEMOD_NFM, o) for o in offs[1:]], seed=6)
    prev = jax_precision.get_handoff_name()
    jax_precision.set_handoff_dtype("bf16")
    precision.set_handoff_dtype("bf16")
    try:
        jvs = jr._build_vfo_shared()
        jp = jr.make_params_shared(offs, squelch_level=lvl)
        pp = pr.make_params_shared(offs, squelch_level=lvl)
        js, ps = jr.init_state_shared(4), pr.init_state_shared(4)
        for b in range(4):
            xb = x[b * T:(b + 1) * T]
            st = dict(js)
            y, st["vfo"] = jvs.apply(jp["vfo"], js["vfo"], jnp.asarray(xb),
                                     _force_kernel=True)
            ja, js = jr._post_vfo(jp, js, st, y, mono_out=True)
            pa, ps = pr.apply_shared(pp, ps, planes(xb), mono_out=True)
            ja = np.asarray(ja)
            assert pa.shape == ja.shape == (4, T // 50)
            assert not pa[0].any() and not ja[0].any()
            assert pa[1:].abs().amax(-1).min() > 0
            assert np.mean(ja[1:].astype(np.float64) ** 2) >= SIGNAL_POWER
            pa = pa.numpy()
            if b == 0:
                q = 3 * pa.shape[-1] // 4
                assert _agree(ja[:, q:], pa[:, q:]) >= NFM_BLOCK0_DB
            else:
                assert _agree(ja, pa) >= MIN_DB, (b, _agree(ja, pa))
            _states_agree(js, ps, MIN_DB)
    finally:
        jax_precision.set_handoff_dtype(prev)
