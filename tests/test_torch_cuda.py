"""The port's CUDA kernels against their plain versions, on the card, over
shapes the main path does not reach (odd channel counts, partial tiles and
windows, both handoff dtypes, every supported FFT size).  These need an
NVIDIA GPU and skip without one; on the GPU machine, which has no JAX, run

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch.ops import fft_kernel, mono_frontend
from sdrplusplusbrown_tpu_torch.ops import precision, wfm_kernel
from sdrplusplusbrown_tpu_torch.ops.spectrum import make_fft_window

from torch_parity import FS, assert_spectra_close, snr_db, wfm_iq

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(params=["float32", "bf16"])
def handoff(request):
    prev = precision.get_handoff_name()
    precision.set_handoff_dtype(request.param)
    yield request.param
    precision.set_handoff_dtype(prev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _close(a, b, min_db, what):
    a = a.detach().cpu().to(torch.complex64 if a.is_complex()
                            else torch.float32).numpy()
    b = b.detach().cpu().to(torch.complex64 if b.is_complex()
                            else torch.float32).numpy()
    assert a.shape == b.shape, what
    if np.any(a):
        assert snr_db(a, b) >= min_db, (what, snr_db(a, b))


def _planes(x, dev):
    return (torch.from_numpy(x.real.copy()).to(dev),
            torch.from_numpy(x.imag.copy()).to(dev))


@pytest.mark.parametrize("C,T", [(1, 24_000), (3, 36_000), (8, 240_000),
                                 (16, 48_000)])
def test_frontend_kernel_matches_plain(gpu, handoff, C, T):
    radio = Radio(FS, DEMOD_WFM)
    bank = radio._build_vfo_shared()
    offs = np.linspace(-1.0e6, 1.0e6, C) if C > 1 else np.array([3e5])
    x = wfm_iq(2 * T, offs, seed=C)
    p = bank.make_params(offs)
    s_cpu = bank.init_state(C)
    s_gpu = _to(s_cpu, gpu)
    n0 = mono_frontend.mono_frontend_kernel.launches
    bound = 80.0 if handoff == "float32" else 60.0
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        y_cpu, s_cpu = bank.apply(p, s_cpu, _planes(xb, "cpu"))
        y_gpu, s_gpu = bank.apply(p, s_gpu, _planes(xb, gpu))
        assert y_gpu.is_cuda and y_gpu.dtype == y_cpu.dtype
        _close(y_cpu, y_gpu, bound, f"IF block {b}")
        for key in ("resamp", "fir"):
            _close(s_cpu[key], s_gpu[key], bound, key)
        _close(s_cpu["fused"]["tail"], s_gpu["fused"]["tail"], 200.0, "tail")
        torch.testing.assert_close(s_gpu["fused"]["phase"].cpu(),
                                   s_cpu["fused"]["phase"])
    assert mono_frontend.mono_frontend_kernel.launches == n0 + 2


@pytest.mark.parametrize("C", [1, 4, 8])
def test_wfm_kernels_match_plain(gpu, handoff, C):
    radio = Radio(FS, DEMOD_WFM)
    bank, dem = radio._build_vfo_shared(), radio.demod
    T = 48_000
    offs = np.linspace(-0.9e6, 0.9e6, C) if C > 1 else np.array([-2e5])
    x = wfm_iq(2 * T, offs, seed=10 + C)
    p = bank.make_params(offs)
    sv, sd = bank.init_state(C), dem.init_state((C,))
    sd_gpu = _to(sd, gpu)
    n2 = wfm_kernel.wfm_demod_kernel.launches
    n3 = wfm_kernel.mpx_audio_poly_kernel.launches
    bound = 70.0 if handoff == "float32" else 50.0
    for b in range(2):
        buf, sv = bank.apply(p, sv, _planes(x[b * T:(b + 1) * T], "cpu"))
        a_cpu, sd = dem.apply_planes(None, sd, buf)
        a_gpu, sd_gpu = dem.apply_planes(None, sd_gpu, buf.to(gpu))
        assert a_gpu.is_cuda and a_gpu.shape == a_cpu.shape
        _close(a_cpu, a_gpu, bound, f"audio block {b}")
        for key in ("quad", "mpx_hist", "audio_rs"):
            _close(sd[key], sd_gpu[key], bound, key)
    assert wfm_kernel.wfm_demod_kernel.launches == n2 + 2
    assert wfm_kernel.mpx_audio_poly_kernel.launches == n3 + 2


@pytest.mark.parametrize("fft_size,interval,n", [(1024, 2_500, 5),
                                                 (2048, 5_000, 3),
                                                 (4096, 12_000, 4),
                                                 (16384, 30_000, 2),
                                                 (65536, 120_000, 2)])
def test_spectrum_kernel_matches_plain(gpu, fft_size, interval, n):
    T = n * interval
    keep = min(interval, fft_size)
    x = wfm_iq(T, np.linspace(-0.9e6, 0.9e6, 4), seed=fft_size)
    win = torch.from_numpy(make_fft_window("nuttall", keep))
    want = fft_kernel.spectrum_frames_db(*_planes(x, "cpu"), keep, interval,
                                         fft_size, -300.0, win)
    got = fft_kernel.spectrum_frames_db(*_planes(x, gpu), keep, interval,
                                        fft_size, -300.0, win.to(gpu))
    assert got.is_cuda
    assert_spectra_close(want.numpy(), got.cpu().numpy())


def test_kernels_raise_instead_of_falling_back(gpu):
    x = _planes(wfm_iq(24_000, [0.0]), gpu)
    win = torch.ones(3000, device=gpu)
    with pytest.raises(ValueError):      # not a power of 2: no CUDA kernel
        fft_kernel.spectrum_frames_db(*x, 3000, 12_000, 3000, -300.0, win)
    pipe = Radio(FS, DEMOD_WFM).demod.pipes()[1]
    raw = torch.zeros((4, 2000), device=gpu)[:, ::2]
    with pytest.raises(ValueError):      # non-contiguous planes
        wfm_kernel.mpx_audio_poly(pipe, raw, 1000,
                                  torch.zeros((4, pipe.hist), device=gpu),
                                  torch.float32)


def test_radio_slice_matches_plain(gpu, handoff):
    from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath
    radio = Radio(FS, DEMOD_WFM)
    sp = SpectrumPath(FS, fft_size=4096, fft_rate=200.0)
    C, T = 4, 48_000
    offs = np.linspace(-0.9e6, 0.9e6, C)
    x = wfm_iq(3 * T, offs, seed=5)
    s_cpu = radio.init_state_shared(C)
    s_gpu = radio.init_state_shared(C)
    bound = 70.0 if handoff == "float32" else 50.0
    for b in range(3):
        p = radio.make_params_shared(offs if b < 2 else offs + 20e3)
        xb = x[b * T:(b + 1) * T]
        (a1, sp1), s_cpu = radio.apply_shared(p, s_cpu, _planes(xb, "cpu"),
                                              spectrum=sp)
        (a2, sp2), s_gpu = radio.apply_shared(p, s_gpu, _planes(xb, gpu),
                                              spectrum=sp)
        assert a2.is_cuda and sp2.is_cuda
        if b:
            _close(a1, a2, bound, f"audio block {b}")
        assert_spectra_close(sp1.numpy(), sp2.cpu().numpy())
