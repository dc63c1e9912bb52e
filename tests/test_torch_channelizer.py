"""The port's 2×-oversampled PFB against the JAX package: the plain
version of kernel K5 (ops/channelizer_kernel.py) against the Pallas V3
kernel in interpret mode, against the V2 and V1 kernels (the JAX tests
hold all three equal), and against JAX's chained OversampledChannelizer,
whose port is that same plain version.  Float32 handoff.

Bounds: 90 dB for bins against V3 (measured 134.6 dB: only the order of
float32 sums differs), 1e-5 absolute against V2 / V1 (the bound JAX sets
between them), states bit-exact (they are slices of the input)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.rx_vfo import ChannelizedRxVFOBank as JaxBank
from sdrplusplusbrown_tpu.ops.pallas_channelizer import (
    PallasChannelizer, PallasChannelizerV2, PallasChannelizerV3)
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.rx_vfo import ChannelizedRxVFOBank
from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel

from torch_parity import FS, planes, port_f32_handoff, snr_db  # noqa: F401

M = 48


@pytest.fixture(scope="module")
def banks():
    return (JaxBank(FS, 50_000.0, 12_500.0),
            ChannelizedRxVFOBank(FS, 50_000.0, 12_500.0, device="cpu"))


def _noise(T, seed):
    rng = np.random.default_rng(seed)
    x = 0.1 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    n = np.arange(T)
    for f in (-700e3, -150e3, 333e3, 901e3):
        x = x + 0.4 * np.exp(2j * np.pi * f * n / FS)
    return x.astype(np.complex64)


def _state_equal(jst, pst):
    for k in jst:
        np.testing.assert_array_equal(convert.state_to_jax(pst[k]),
                                      np.asarray(jst[k]), err_msg=k)


def test_designs_bit_identical(banks):
    jb, pb = banks
    np.testing.assert_array_equal(pb.chz.branches, jb.chz.branches)
    assert pb.chz.branches.shape == (M, 6)
    for name in ("decim2", "fir"):
        np.testing.assert_array_equal(getattr(pb, name).taps,
                                      getattr(jb, name).taps)


def test_pfb_matches_jax_v3_with_state_interchange(banks):
    jb, pb = banks
    pfb, post = pb.pipes()
    v3 = PallasChannelizerV3(jb.chz, interpret=True)
    T = 48 * 2000
    Tb = 2 * T // M
    W = post.plan(Tb)["Tb_pad"]
    x = _noise(2 * T, seed=1)
    js = jb.chz.init_state()
    ps = pb.init_state(8)["chz"]
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jbins, js_next = v3.apply(js, jnp.asarray(xb), W)
        pbins, ps_next = pfb.apply(ps, planes(xb), W)
        assert pbins.shape == (2 * M, W) and pbins.dtype == torch.float32
        jbins = np.asarray(jbins)
        assert snr_db(jbins[:, :Tb], pbins.numpy()[:, :Tb]) >= 90.0
        # the padded frames come from the zero-extended stream, as on the
        # TPU
        assert snr_db(jbins, pbins.numpy()) >= 90.0
        _state_equal(js_next, ps_next)
        # interchange mid-stream: each side continues from the other's
        js = convert.state_to_jax(ps_next)
        ps = convert.state_from_jax(js_next, device="cpu")


def test_pfb_matches_jax_v2_and_v1(banks):
    """V2 and V1 compute the same function (tests/test_chan_frontend.py
    holds them equal on this partial-last-block length)."""
    jb, pb = banks
    pfb, _ = pb.pipes()
    T = 384 * 30
    Tb = 2 * T // M
    W = -(-Tb // 256) * 256
    x = _noise(T, seed=2)
    st = jb.chz.init_state()
    pbins, pst = pfb.apply(convert.state_from_jax(st, device="cpu"),
                           planes(x), W)
    for cls in (PallasChannelizerV2, PallasChannelizer):
        kern = cls(jb.chz, interpret=True)
        assert kern.supported
        jbins, jst = kern.apply(st, jnp.asarray(x), W,
                                out_dtype=jnp.float32)
        err = np.abs(np.asarray(jbins)[:, :Tb] - pbins.numpy()[:, :Tb])
        assert err.max() < 1e-5, (cls.__name__, err.max())
        for k in jst:
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                       atol=1e-6)


def test_chained_channelizer_like_jax(banks):
    jb, pb = banks
    x = _noise(48 * 500, seed=3)
    jy, jst = jb.chz.apply(None, jb.chz.init_state(), jnp.asarray(x))
    py, pst = pb.chz.apply(None, pb.chz.init_state(), torch.from_numpy(x))
    assert py.shape == (M, 1000)
    assert snr_db(np.asarray(jy), py.numpy()) > 120.0
    _state_equal(jst, pst)
    (yr, yi), _ = pb.chz.apply_planes(pb.chz.init_state(),
                                      torch.from_numpy(x))
    stacked, _ = pb.chz.apply_planes(pb.chz.init_state(),
                                     torch.from_numpy(x), pad_to=1024)
    assert stacked.shape == (2 * M, 1024)
    np.testing.assert_array_equal(stacked[:M, :1000].numpy(), yr.numpy())
    np.testing.assert_array_equal(stacked[M:, :1000].numpy(), yi.numpy())
    assert not stacked[:, 1000:].any()


def test_pfb_plain_matches_chained_block(banks):
    """K5's closed form (one window per frame), through the bank's K5
    configuration, == JAX's two-pass chained channelizer, across two
    calls with the state carried on each side."""
    jb, pb = banks
    pfb, _ = pb.pipes()
    assert pfb is pb.chz.pfb()
    T = 48 * 400
    x = _noise(2 * T, seed=4)
    js, ps = jb.chz.init_state(), pb.chz.init_state()
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        want, js = jb.chz.apply(None, js, jnp.asarray(xb))
        got, ps = pfb.apply(ps, planes(xb), 2 * T // M)
        assert snr_db(np.asarray(want), torch.complex(got[:M], got[M:])
                      .numpy()) > 120.0
        _state_equal(js, ps)
    assert channelizer_kernel.pfb_bins_kernel.launches == 0
