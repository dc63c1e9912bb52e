"""Kernel K10 (the WFM stereo section launched alone): its plain version
against the JAX package's ``wfm_stereo_apply`` (``_wfm_stereo_kernel`` in
interpret mode) at C = 8 on the MPX of a stereo broadcast, float32, bar
100 dB; and BroadcastFM's stereo routes (a 2-D MPX on the card runs K10,
the CPU the per-stage section that advances every state key)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops.pallas_wfm import wfm_stereo_apply
from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch.ops import wfm_kernel

from torch_parity import FS, port_f32_handoff, snr_db  # noqa: F401

C = 8
T = 12_500           # one 0.1 s block at the 125 kHz MPX rate


def _mpx(n, seed):
    """C stereo MPX rows: L tone, 19 kHz pilot, L−R on 38 kHz, noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 125_000.0
    rows = []
    for c in range(C):
        tone = np.sin(2 * np.pi * (500.0 + 60.0 * c) * t)
        rows.append(0.45 * tone + 0.45 * tone * -np.cos(2 * np.pi * 38e3 * t)
                    + 0.1 * np.sin(2 * np.pi * 19e3 * t + 0.3 * c)
                    + 1e-3 * rng.standard_normal(n))
    return np.stack(rows).astype(np.float32)


def test_stereo_plain_matches_pallas_stereo():
    dem = Radio(FS, DEMOD_WFM, device="cpu").demod
    pipe = dem.pipes()[0]
    K = len(dem.pilot_taps)
    ext = _mpx(K + T, seed=3)
    want = np.asarray(wfm_stereo_apply(jnp.asarray(ext), dem.pilot_taps,
                                       dem.pilot_phase_corr,
                                       dem.lpr_delay.delay, interpret=True))
    got = wfm_kernel.wfm_stereo(pipe, torch.from_numpy(ext[:, K:]),
                                torch.from_numpy(ext[:, :K]))
    assert got.shape == want.shape == (2, C, T)
    s = snr_db(want, got.numpy())
    assert s >= 100.0, s


def test_stereo_section_routes():
    """On the CPU a 2-D MPX takes the per-stage section, which advances
    every key and agrees with K10's plain version once the pilot FIR and
    the lag have filled (the two differ only in the division guard)."""
    dem = Radio(FS, DEMOD_WFM, device="cpu").demod
    pipe = dem.pipes()[0]
    K = len(dem.pilot_taps)
    mpx = torch.from_numpy(_mpx(2 * T, seed=4))
    state = {k: v for k, v in dem.init_state((C,)).items()}
    st = dict(state)
    lr1 = dem._stereo_section(state, st, mpx[:, :T])
    st2 = dict(st)
    lr2 = dem._stereo_section(st, st2, mpx[:, T:])
    for key in ("pilot_fir", "pilot_lag", "lpr_delay", "lmr_delay",
                "mpx_hist"):
        assert not torch.equal(st2[key], state[key]), key
    torch.testing.assert_close(st2["mpx_hist"], mpx[:, -K:])
    ref = wfm_kernel.wfm_stereo(pipe, mpx[:, T:].contiguous(),
                                st["mpx_hist"].contiguous())
    assert lr1.shape == lr2.shape == ref.shape == (2, C, T)
    assert snr_db(ref.numpy(), lr2.numpy()) > 80.0
    with pytest.raises(ValueError):
        wfm_kernel.wfm_stereo(pipe, mpx[:, :T], torch.zeros(C, K - 1))
