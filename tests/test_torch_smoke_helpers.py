"""chip_smoke.py's host-side helpers, which need no GPU: the work counts
behind each kernel's bound, and the profiler's kernel-name shortening."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.rx_vfo import ChannelizedRxVFOBank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("odt, nbytes", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k5_bound_counts_an_fft_and_is_bound_by_bytes(smoke, odt, nbytes):
    """scanner128's K5: 240 000 input samples, M = 48, 288 taps; the DFT
    counts 5·M·log2 M flops per frame, so the bytes bound it."""
    bank = ChannelizedRxVFOBank(2.4e6, 50e3, 12.5e3, device="cpu")
    pfb, post = bank.pipes()
    T, M = 240_000, 48
    Tb = 2 * T // M
    W = post.plan(Tb)["Tb_pad"]
    xr = torch.zeros(T)
    args = (pfb, xr, xr, None, None, W, odt, odt)
    b, ops = smoke.work("K5", args)
    assert b == 8 * T + 2 * M * W * nbytes
    assert ops == pytest.approx(Tb * (4 * 288 + 5 * M * np.log2(M)))
    ms, by = smoke.bound("K5", args)
    assert by == "bytes"
    assert ms == pytest.approx(b / smoke.HBM_BPS * 1e3)


def test_short_kernel_names(smoke):
    assert smoke.short_kernel(
        "(anonymous namespace)::fm_audio_kernel(void const*, int)") \
        == "fm_audio_kernel"
    assert smoke.short_kernel(
        "void at::native::vectorized_elementwise_kernel<8, "
        "at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)"
        ">(int)") == "vectorized_elementwise_kernel"
    assert smoke.short_kernel("Memcpy DtoD (Device -> Device)") \
        == "Memcpy DtoD"


@pytest.mark.parametrize("cplx,rows,I,D,kw", [(True, 1, 1, 4, 304),
                                              (False, 8, 48, 125, 368)])
def test_app_stage_names_each_k8_geometry(smoke, cplx, rows, I, D, kw):
    """Phase 10 holds every distinct K8 geometry against its plain
    version: the name tells dtype, rows, I/D and kernel width apart."""
    dt = torch.complex64 if cplx else torch.float32
    shape = (1000,) if rows == 1 else (rows, 1000)
    call = (torch.zeros(shape, dtype=dt), torch.zeros(shape[:-1] + (7,),
                                                      dtype=dt),
            torch.zeros(I, kw), I, D)
    assert smoke.app_stage(call) == (
        f"{'complex' if cplx else 'real'} rows {rows} I/D {I}/{D} kw {kw}")
