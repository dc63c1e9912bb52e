"""The channelized (PFB) VFO bank, the wide-C front end of the scanner: the
seven signal-level oracles of the JAX package's
``tests/test_channelized_bank.py``, on the port (its plain versions on the
CPU).  The PFB path is signal-equivalent, not bit-near, to the per-channel
RxVFO chain (reference core/src/dsp/channel/rx_vfo.h:89-121), so these
hold tone placement at the op level, audio parity with the per-channel
path, streaming continuity, params-only retune, the bank's automatic
choice of the PFB, the rejection of geometries it cannot serve, and the
rejection of an alias from an adjacent channel."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_NFM, DEMOD_WFM,
                                                     Radio)
from sdrplusplusbrown_tpu_torch.models.radio_bank import RadioBank, VFOSpec
from sdrplusplusbrown_tpu_torch.models.rx_vfo import ChannelizedRxVFOBank
from sdrplusplusbrown_tpu_torch.ops import taps as taps_mod
from sdrplusplusbrown_tpu_torch.ops.channelizer import OversampledChannelizer

from torch_parity import port_f32_handoff  # noqa: F401

FS = 2_400_000.0
OUT = 50_000.0
BW = 12_500.0
M = 48


def test_oversampled_channelizer_tone_placement():
    chz = OversampledChannelizer(FS, M, taps_mod.low_pass(OUT, OUT - BW, FS))
    T = 48_000
    n = np.arange(2 * T)
    b, delta = 7, 11_000.0
    x = torch.from_numpy(np.exp(2j * np.pi * (b * OUT + delta) * n / FS)
                         .astype(np.complex64))
    y1, st = chz.apply(None, chz.init_state(), x[:T])
    y2, _ = chz.apply(None, st, x[T:])
    y = torch.cat([y1, y2], dim=-1).numpy()
    # bin b carries exp(j2π·delta·t_j/fs) at the frame positions
    # t_j = j·M/2 − M/2 (the delayed frames interleave half a hop early)
    j = np.arange(y.shape[-1])
    ref = np.exp(2j * np.pi * delta * (j * (M // 2) - M // 2) / FS)
    seg, refs = y[b, 50:-50], ref[50:-50]
    g = np.vdot(refs, seg) / np.vdot(refs, refs)
    err = seg - g * refs
    snr = 10 * np.log10(np.mean(np.abs(g * refs) ** 2)
                        / max(np.mean(np.abs(err) ** 2), 1e-30))
    assert abs(abs(g) - 1.0) < 1e-3
    assert snr > 100.0


def _nfm_multiplex(offs, T, seed, dev=2.5e3):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    x = np.zeros(T, np.complex128)
    for i, off in enumerate(offs):
        tone = 0.6 * np.sin(2 * np.pi * (400 + 150 * i) * n / FS)
        ph = 2 * np.pi * np.cumsum(dev * tone) / FS
        x += np.exp(1j * (ph + 2 * np.pi * off * n / FS))
    x = x / len(offs) + 0.002 * (rng.standard_normal(T)
                                 + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def _tone_snr(a, f0, sr=48_000.0):
    a = np.asarray(a, np.float64) - np.mean(a)
    N = len(a)
    S = np.abs(np.fft.rfft(a * np.hanning(N))) ** 2
    fr = np.fft.rfftfreq(N, 1.0 / sr)
    sig = S[np.abs(fr - f0) < 50].sum()
    tot = S[fr > 20].sum()
    return 10 * np.log10(sig / max(tot - sig, 1e-30))


def _block(radio, seconds):
    g = radio.in_multiple
    return -(-int(FS * seconds) // g) * g


def test_channelized_audio_matches_per_channel():
    """Eight squelched NFM channels at off-grid offsets across the band:
    the PFB path's audio carries each channel's tone at > 25 dB SNR and at
    most 1 dB under the per-channel ``Radio.apply`` chain's."""
    C = 8
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True, device="cpu")
    assert radio.can_channelize()
    T = _block(radio, 0.1)
    offs = np.linspace(-1.05e6, 1.08e6, C) + 3217.0
    x = torch.from_numpy(_nfm_multiplex(offs, T, seed=1))
    yu, _ = radio.apply(radio.make_params(offs), radio.init_state((C,)), x)
    yc, _ = radio.apply_channelized(radio.make_params_channelized(offs),
                                    radio.init_state_channelized(C), x)
    assert yc.shape == yu.shape == (C, 2, T // 50)
    for i in range(C):
        f0 = 400 + 150 * i
        su = _tone_snr(yu[i, 0, 2000:].numpy(), f0)
        sc = _tone_snr(yc[i, 0, 2000:].numpy(), f0)
        assert sc > 25.0, (i, sc)
        assert sc > su - 1.0, (i, su, sc)


def test_channelized_bank_streaming_continuity():
    """Block-wise IF == one-shot IF (the carried state is exact; the bound
    is the float32 NCO phase carry, ~1e-4 rad a block)."""
    C, nblk, T = 4, 3, 48_000
    bank = ChannelizedRxVFOBank(FS, OUT, BW, device="cpu")
    offs = np.array([-913e3, -201e3, 47e3, 1.013e6]) + 1234.0
    p = bank.make_params(offs)
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(nblk * T)
                          + 1j * rng.standard_normal(nblk * T))
                         .astype(np.complex64) * 0.3)
    st, parts = bank.init_state(C), []
    for b in range(nblk):
        y, _, st = bank.apply(p, st, x[b * T:(b + 1) * T])
        parts.append(y)
    blocked = torch.cat(parts, dim=-1).numpy()
    oneshot = bank.apply(p, bank.init_state(C), x)[0].numpy()
    err = np.abs(blocked - oneshot)
    snr = 10 * np.log10(np.mean(np.abs(oneshot) ** 2)
                        / max(np.mean(err ** 2), 1e-30))
    assert snr > 80.0


def test_channelized_retune_is_params_only():
    """One radio serves a retuned bank: new offsets, nothing rebuilt."""
    C = 4
    radio = Radio(FS, DEMOD_NFM, device="cpu")
    T = _block(radio, 0.15)
    f_target = 731e3 + 911.0
    offs_a = np.array([-1.0e6, -0.4e6, 0.2e6, 0.9e6])     # none on target
    offs_b = np.array([-1.0e6, f_target, 0.2e6, 0.9e6])   # ch1 retuned
    x = torch.from_numpy(_nfm_multiplex([f_target], T, seed=3))
    ya, _ = radio.apply_channelized(radio.make_params_channelized(offs_a),
                                    radio.init_state_channelized(C), x)
    built = radio._build_vfo_channelized()
    yb, _ = radio.apply_channelized(radio.make_params_channelized(offs_b),
                                    radio.init_state_channelized(C), x)
    assert radio._build_vfo_channelized() is built
    sa = _tone_snr(ya[1, 0, 2000:].numpy(), 400)
    sb = _tone_snr(yb[1, 0, 2000:].numpy(), 400)
    assert sb > 25.0
    assert sb > sa + 20.0


def test_radio_bank_auto_channelize():
    """A wide NFM group takes the PFB path, a WFM group (in/IF ratio 4.8)
    the shared front end; both give working audio."""
    C = 16
    f0s = np.linspace(-1.0e6, 1.0e6, C) + 531.0
    vfos = [VFOSpec(f"nfm{i}", DEMOD_NFM, f0s[i]) for i in range(C)]
    vfos.append(VFOSpec("wfm0", DEMOD_WFM, 150e3))
    bank = RadioBank(FS, vfos, device="cpu")
    assert bank.channelized[DEMOD_NFM] is True
    assert bank.channelized[DEMOD_WFM] is False
    g = bank.in_multiple
    T = -(-360_000 // g) * g
    x = torch.from_numpy(_nfm_multiplex(f0s[:3], T, seed=4))
    outs, _ = bank.apply(bank.make_params(), bank.init_state(), x)
    assert outs[DEMOD_WFM].shape == (1, 2, T // 50)
    for i in range(3):
        s = _tone_snr(outs[DEMOD_NFM][i, 0, 2000:].numpy(), 400 + 150 * i)
        assert s > 25.0, (i, s)


def test_channelized_rejects_bad_ratio():
    with pytest.raises(ValueError):
        ChannelizedRxVFOBank(FS, 500_000.0, 150e3, device="cpu")  # 4.8
    with pytest.raises(ValueError):       # no transition room
        ChannelizedRxVFOBank(FS, 50_000.0, 50_000.0, device="cpu")


def test_offchannel_alias_rejection():
    """A strong carrier ~out_sr from a channel's centre must not open that
    channel's squelch: components at out_sr ± bw/2 fold into the passband
    after the 2:1 decimation, so decim2's stopband starts by out_sr −
    bw/2.  Scanner128's grid, an NFM carrier on channel 17 only: exactly
    channel 17 opens."""
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True, device="cpu")
    T = _block(radio, 0.1)
    C = 128
    offs = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    n = np.arange(2 * T)
    m = 0.6 * np.sin(2 * np.pi * 800.0 * n / FS)
    ph = 2 * np.pi * 2.5e3 * np.cumsum(m) / FS
    x = torch.from_numpy((0.5 * np.exp(1j * (2 * np.pi * offs[17] * n / FS
                                              + ph))).astype(np.complex64))
    params = radio.make_params_channelized(offs, squelch_level=-30.0)
    _, st = radio.apply_channelized(params, radio.init_state_channelized(C),
                                    x[:T])
    audio, _ = radio.apply_channelized(params, st, x[T:])
    pw = np.mean(audio[:, 0].numpy().astype(np.float64) ** 2, axis=-1)
    assert set(np.nonzero(pw > 1e-8)[0].tolist()) == {17}
    assert pw[17] > 1e-3
