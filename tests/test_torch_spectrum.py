"""Kernel K4's plain version (the port's framed power spectrum) against the
JAX package's framed spectrum kernel in interpret mode.  Frames start at
rup(f·interval, 1024), the kernel path's framing.  Bins within 60 dB of
the frame peak agree to <= 0.01 dB (10x the JAX kernel's own error against
a float64 FFT), bins within 80 dB to <= 0.1 dB."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops.pallas_fft import spectrum_frames_db as jax_db
from sdrplusplusbrown_tpu.ops.spectrum import make_fft_window
from sdrplusplusbrown_tpu_torch.ops import fft_kernel
from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

from torch_parity import (FS, assert_spectra_close, planes,
                          port_f32_handoff, wfm_iq)  # noqa: F401


@pytest.mark.parametrize("fft_size,interval,T", [
    (4096, 12_160, 24_320),      # two frames; the second starts at 12 288
    (65536, 66_560, 66_560),     # one full-size frame
])
def test_spectrum_matches_jax_kernel(fft_size, interval, T):
    x = wfm_iq(T, np.linspace(-0.9e6, 0.9e6, 4), seed=11)
    win = make_fft_window("nuttall", fft_size)
    want = np.asarray(jax_db(jnp.asarray(x.real), jnp.asarray(x.imag),
                             fft_size, interval, fft_size, -300.0, win,
                             interpret=True))
    xr, xi = planes(x)
    got = fft_kernel.spectrum_frames_db(xr, xi, fft_size, interval,
                                        fft_size, -300.0,
                                        torch.from_numpy(win))
    assert got.shape == (T // interval, fft_size)
    assert_spectra_close(want, got.numpy())


def test_spectrum_path_frames_and_peaks():
    """SpectrumPath frames at rup(f·interval, 1024) and puts each carrier
    at its DC-centred bin."""
    sp = SpectrumPath(FS, fft_size=4096, fft_rate=200.0, device="cpu")
    T = 4 * sp.reshaper.interval
    offsets = np.linspace(-0.9e6, 0.9e6, 4)
    x = wfm_iq(T, offsets, seed=3)
    db, _ = sp.apply(None, None, planes(x))
    assert db.shape == (4, 4096)
    assert fft_kernel.frame_starts(T, 4096, 12_000) == [0, 12_288, 24_576,
                                                        36_864]
    row = db[1].numpy()
    for o in offsets:
        k = int((o / FS + 0.5) * 4096)
        assert row[k - 64:k + 64].max() > np.percentile(row, 5) + 30.0, o
    with pytest.raises(ValueError):
        fft_kernel.frame_starts(12_000, 4096, 3_000)   # last frame overruns
