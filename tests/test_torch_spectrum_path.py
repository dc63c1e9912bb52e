"""Kernel K4f (the spectrum of a complex block, frames at exactly
f·interval): its plain version against the JAX package's
``fft_power_db_planes`` (``_fft_pow_kernel`` in interpret mode) at 1024 and
4096 points, and the port's ``SpectrumPath`` on a complex block against
the JAX package's on the app's configuration (2.4 MS/s, 65 536 bins at 20
fps: frames of 65 536 every 120 000 samples).  Bins within 60 dB of the
frame peak agree to <= 0.01 dB, within 80 dB to <= 0.1 dB.  Before the
repair the port framed a complex block at rup(f·interval, 1024) and frame
1 differed by up to 17 dB."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops.pallas_fft import fft_power_db_planes
from sdrplusplusbrown_tpu.ops.spectrum import (SpectrumPath as JaxSpectrum,
                                               make_fft_window)
from sdrplusplusbrown_tpu_torch.ops import fft_kernel
from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

from torch_parity import (FS, assert_spectra_close, planes,
                          port_f32_handoff, wfm_iq)  # noqa: F401


def swept_carrier(T: int, seed: int = 0) -> np.ndarray:
    """A carrier sweeping −0.8 → +0.8 MHz over the block, plus noise: each
    frame sees its own tone, so a frame taken at another start shows."""
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    f = -0.8e6 + 1.6e6 * n / T
    phase = 2 * np.pi * np.cumsum(f) / FS
    x = 0.5 * np.exp(1j * phase) + 1e-3 * (rng.standard_normal(T)
                                           + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


@pytest.mark.parametrize("fft_size,F", [(1024, 3), (4096, 2)])
def test_exact_frames_match_pallas_fft_pow(fft_size, F):
    x = wfm_iq(F * fft_size, np.linspace(-0.9e6, 0.9e6, 4), seed=fft_size)
    win = make_fft_window("nuttall", fft_size)
    fr = x.reshape(F, fft_size)
    want = np.asarray(fft_power_db_planes(
        jnp.asarray(fr.real), jnp.asarray(fr.imag), fft_size, -300.0,
        window=win, interpret=True))
    got = fft_kernel.spectrum_path_db(torch.from_numpy(x), fft_size,
                                      fft_size, fft_size, -300.0,
                                      torch.from_numpy(win))
    assert got.shape == (F, fft_size)
    assert_spectra_close(want, got.numpy())
    # the same pre-framed frames as (xr, xi) planes, through K4
    from_planes = fft_kernel.spectrum_frames_db(
        *planes(x), fft_size, fft_size, fft_size, -300.0,
        torch.from_numpy(win))
    assert_spectra_close(want, from_planes.numpy())


def test_spectrum_path_frames_a_complex_block_like_jax():
    """The app's spectrum: every frame of a swept carrier agrees."""
    jsp = JaxSpectrum(FS, 65536, 20.0)
    psp = SpectrumPath(FS, 65536, 20.0, device="cpu")
    assert (psp.reshaper.keep, psp.reshaper.interval) == (65536, 120_000)
    T = 2 * psp.reshaper.interval
    x = swept_carrier(T, seed=5)
    want, _ = jsp.apply(None, None, jnp.asarray(x))
    got, _ = psp.apply(None, None, torch.from_numpy(x))
    assert got.shape == (2, 65536)
    assert_spectra_close(np.asarray(want), got.numpy())
    # the planes keep the front-end kernel path's 1024-aligned starts
    aligned, _ = psp.apply(None, None, planes(x))
    torch.testing.assert_close(aligned[0], got[0])
    assert (aligned[1] - got[1]).abs().max() > 1.0


def test_exact_frame_starts():
    assert fft_kernel.frame_starts(240_000, 65536, 120_000, align=1) == [
        0, 120_000]
    with pytest.raises(ValueError):
        fft_kernel.spectrum_path_db(torch.zeros(1000, dtype=torch.complex64),
                                    1024, 1024, 1024, -300.0, None)
    with pytest.raises(ValueError):          # planes go to K4, not K4f
        fft_kernel.spectrum_path_db(torch.zeros(4096), 1024, 1024, 1024,
                                    -300.0, None)
