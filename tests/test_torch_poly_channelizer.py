"""The critically sampled channelizer and the channelizer64 step
(bench.py:build_channelizer64, BASELINE config 4) against the JAX package.

  * ``PolyphaseChannelizer``'s design (branches, tpp, channel centres) is
    the JAX block's, bit for bit.
  * Its plain ``apply`` against the JAX ``apply`` (branch FIR, jnp.fft):
    >= 100 dB over two calls, float32, the state exact.
  * ``apply_planes`` (K5's critical form, its plain version) against the
    JAX ``apply_planes(..., interpret=True)`` (``_chz3_kernel`` critical,
    ``PallasPolyChannelizerV3``) at M = 16 and 64 over two calls: >= 120 dB
    in the float32 handoff (measured 133-137 dB: only the order of float32
    sums differs), >= 45 dB in bf16 (a float32 difference across a bf16
    rounding boundary moves a value by 2^-8; measured 94-135 dB), the
    state exact; and against the V2 body (``PallasPolyChannelizer``), in
    interpret mode, >= 120 dB (measured 131.8 dB).
  * The state interchanges exactly between ``apply`` and ``apply_planes``
    and with the JAX package's.
  * ``fft_power_db_planes`` (K4r's plain version) on float32 and bf16 bin
    views against the JAX function in interpret mode: bins within 60 dB
    of each frame's peak <= 0.01 dB, within 80 dB <= 0.1 dB.
  * The whole step at M = 64, T = 131 072 (two spectrum frames per
    channel) against the TPU route composed by hand (on the CPU the JAX
    bench's own branch takes |FFT|², not dB): two steps, float32.
  * The oracles of the JAX ``tests/test_channelizer.py``: tone routing,
    streaming continuity, channel centres.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu.ops.channelizer import \
    PolyphaseChannelizer as JaxPoly
from sdrplusplusbrown_tpu.ops.pallas_channelizer import (
    PallasPolyChannelizer, PallasPolyChannelizerV3)
from sdrplusplusbrown_tpu.ops.pallas_fft import \
    fft_power_db_planes as jax_fft_db
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel, fft_kernel
from sdrplusplusbrown_tpu_torch.ops import precision
from sdrplusplusbrown_tpu_torch.ops.channelizer import PolyphaseChannelizer

from torch_parity import (_chip_smoke, assert_spectra_close, planes,
                          port_f32_handoff, snr_db)  # noqa: F401

FS = 10_000_000.0


def _pair(M, fs=FS):
    return JaxPoly(fs, M), PolyphaseChannelizer(fs, M, device="cpu")


def _noise(T, seed, M=64, fs=FS):
    """N(0, 0.1²) noise plus a tone on three channel centres (+ 1.3 kHz)."""
    rng = np.random.default_rng(seed)
    x = 0.1 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    n = np.arange(T)
    for m in (1, M // 2 - 3, M - 5):
        f = (m if m <= M // 2 else m - M) * fs / M + 1.3e3
        x = x + 0.3 * np.exp(2j * np.pi * f * n / fs)
    return x.astype(np.complex64)


@pytest.fixture
def bf16_both():
    prev = jax_precision.get_handoff_name()
    jax_precision.set_handoff_dtype("bf16")
    precision.set_handoff_dtype("bf16")
    yield
    jax_precision.set_handoff_dtype(prev)


@pytest.mark.parametrize("M", [64, 16])
def test_design_matches_jax(M):
    jc, pc = _pair(M)
    assert pc.tpp == jc.tpp == 19
    np.testing.assert_array_equal(pc.branches, jc.branches)
    np.testing.assert_array_equal(pc.channel_freqs(), jc.channel_freqs())
    assert (pc.ratio, pc.in_multiple) == (jc.ratio, jc.in_multiple)
    st = pc.init_state()
    assert st.shape == np.asarray(jc.init_state()).shape == (M, 18)
    assert st.dtype == torch.complex64 and not st.any()


@pytest.mark.parametrize("M", [64, 16])
def test_plain_apply_matches_jax(M):
    jc, pc = _pair(M)
    T = 256 * M
    x = _noise(2 * T, seed=M, M=M)
    js, ps = jc.init_state(), pc.init_state()
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jy, js = jc.apply(None, js, jnp.asarray(xb))
        py, ps = pc.apply(None, ps, torch.from_numpy(xb))
        assert py.shape == (M, T // M) and py.dtype == torch.complex64
        assert snr_db(np.asarray(jy), py.numpy()) >= 100.0
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert channelizer_kernel.pfb_critical_bins_kernel.launches == 0


def _planes_case(M, handoff):
    jc, pc = _pair(M)
    T = 2 * 256 * M
    x = _noise(2 * T, seed=3 * M, M=M)
    js, ps = jc.init_state(), pc.init_state()
    bound = 120.0 if handoff == "float32" else 45.0
    k = T // M
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jb, js = jc.apply_planes(js, (jnp.asarray(xb.real),
                                      jnp.asarray(xb.imag)), interpret=True)
        pb, ps = pc.apply_planes(ps, planes(xb))
        assert pb.shape == (2 * M, 512) == tuple(jb.shape)
        assert pb.dtype == precision.get_handoff_dtype()
        jb = np.asarray(jb.astype(jnp.float32))
        assert snr_db(jb[:, :k], pb.float().numpy()[:, :k]) >= bound
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("M", [16, 64])
def test_apply_planes_matches_jax_v3(M):
    _planes_case(M, "float32")


@pytest.mark.parametrize("M", [16, 64])
def test_apply_planes_matches_jax_v3_bf16(M, bf16_both):
    _planes_case(M, "bf16")


def test_apply_planes_matches_jax_v2():
    """Where V3 declines, the JAX package falls back to the V2 body
    (``PallasPolyChannelizer``): the same function, held here at M = 16
    (float32, the V2 kernel forced in interpret mode)."""
    jc, pc = _pair(16)
    v2 = PallasPolyChannelizer(jc, interpret=True)
    assert v2.supported and PallasPolyChannelizerV3(jc).supported
    T = 256 * 16
    x = _noise(2 * T, seed=5, M=16)
    js, ps = jc.init_state(), pc.init_state()
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jb, js = v2.apply(js, jnp.asarray(xb), 256, out_dtype=jnp.float32)
        pb, ps = pc.apply_planes(ps, torch.from_numpy(xb))
        assert snr_db(np.asarray(jb), pb.numpy()) >= 120.0
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_state_interchange():
    """``apply`` → ``apply_planes`` → ``apply`` equals three ``apply``s,
    and a JAX state converted in continues exactly."""
    jc, pc = _pair(16)
    T = 16 * 300
    x = _noise(3 * T, seed=9, M=16)
    blocks = [torch.from_numpy(x[b * T:(b + 1) * T]) for b in range(3)]
    st, want = pc.init_state(), []
    for xb in blocks:
        y, st = pc.apply(None, st, xb)
        want.append(y)
    st = pc.init_state()
    y0, st = pc.apply(None, st, blocks[0])
    bins, st = pc.apply_planes(st, blocks[1], out_dtype=torch.float32)
    y2, _ = pc.apply(None, st, blocks[2])
    torch.testing.assert_close(y0, want[0], rtol=0, atol=0)
    torch.testing.assert_close(y2, want[2], rtol=0, atol=0)
    k = T // 16
    assert snr_db(want[1].numpy(), torch.complex(
        bins[:16, :k], bins[16:, :k]).numpy()) >= 120.0
    # a JAX state, converted, continues as the JAX block does
    js = jc.init_state()
    _, js = jc.apply(None, js, jnp.asarray(x[:T]))
    jy, js2 = jc.apply(None, js, jnp.asarray(x[T:2 * T]))
    py, ps2 = pc.apply(None, convert.state_from_jax(js, device="cpu"),
                       blocks[1])
    assert snr_db(np.asarray(jy), py.numpy()) >= 100.0
    np.testing.assert_array_equal(convert.state_to_jax(ps2), np.asarray(js2))


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_fft_power_db_planes_matches_jax(dtype):
    """K4r's plain version on [M, F, 1024] views of a [2M, W] bin stack
    (W past the valid frames, as the step reads them) against the JAX
    function on the same values."""
    M, F, W = 8, 2, 2304
    rng = np.random.default_rng(11)
    n = np.arange(F * 1024)
    bins = 0.05 * rng.standard_normal((2 * M, W))
    for m in range(M):
        z = np.exp(2j * np.pi * (37 * m + 3.3) * n / 1024)
        bins[m, :F * 1024] += z.real
        bins[M + m, :F * 1024] += z.imag
    tdt = {"float32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    pt = torch.from_numpy(bins.astype(np.float32)).to(tdt)
    xr = pt[:M, :F * 1024].reshape(M, F, 1024)
    xi = pt[M:, :F * 1024].reshape(M, F, 1024)
    got = fft_kernel.fft_power_db_planes(xr, xi, 1024)
    assert got.shape == (M, F, 1024) and got.dtype == torch.float32
    jr = jnp.asarray(xr.float().numpy()).astype(jdt)
    ji = jnp.asarray(xi.float().numpy()).astype(jdt)
    want = np.asarray(jax_fft_db(jr, ji, 1024, interpret=True))
    assert_spectra_close(want, got.numpy())
    assert fft_kernel.fft_power_db_planes_kernel.launches == 0


def test_channelizer64_step_matches_jax():
    """bench.py's channelizer64 step (M = 64, 10 MS/s) at T = 131 072, two
    steps, against the TPU route composed from the JAX package's own
    functions in interpret mode: spectra as above, the state exact."""
    smoke = _chip_smoke()
    T = 131_072
    ch, step = smoke.channelizer64("cpu", T)
    jc = JaxPoly(smoke.CHZ_FS, smoke.CHZ_M)
    M, k = smoke.CHZ_M, T // smoke.CHZ_M
    xr, xi = smoke.channelizer64_noise(2 * T)
    js, ps = jc.init_state(), ch.init_state()
    for b in range(2):
        sl = slice(b * T, (b + 1) * T)
        bins, js = jc.apply_planes(js, (jnp.asarray(xr[sl]),
                                        jnp.asarray(xi[sl])), interpret=True)
        want = np.asarray(jax_fft_db(bins[:M, :k].reshape(M, -1, 1024),
                                     bins[M:, :k].reshape(M, -1, 1024),
                                     1024, interpret=True))
        got, ps = step(ps, (torch.from_numpy(xr[sl]),
                            torch.from_numpy(xi[sl])))
        assert got.shape == want.shape == (M, 2, 1024)
        assert_spectra_close(want, got.numpy())
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# ---- the oracles of the JAX package's tests/test_channelizer.py ----------

def test_channelizer_tone_routing():
    fs, M = 64_000.0, 16
    ch = PolyphaseChannelizer(fs, M, device="cpu")
    T = 8192 * M // 16
    n = np.arange(T)
    # tones at channel centres 3 and -2 (bins 3 and M-2)
    x = (np.exp(2j * np.pi * 3 * fs / M * n / fs)
         + 0.5 * np.exp(2j * np.pi * -2 * fs / M * n / fs)).astype(
             np.complex64)
    y, _ = ch.apply(None, ch.init_state(), torch.from_numpy(x))
    assert y.shape == (M, T // M)
    y2 = y.numpy()[:, ch.tpp:]                  # past the warm-up
    p = np.mean(np.abs(y2) ** 2, axis=-1)
    assert set(np.argsort(p)[::-1][:2]) == {3, M - 2}
    # the tone in channel 3 sits at its DC: a constant envelope
    assert np.std(np.abs(y2[3])) / np.mean(np.abs(y2[3])) < 0.02
    assert 10 * np.log10(p[4] / p[3]) < -40.0   # adjacent channel


def test_channelizer_streaming_continuity(rng):
    fs, M = 32_000.0, 8
    ch = PolyphaseChannelizer(fs, M, device="cpu")
    T = 4096
    x = torch.from_numpy((rng.standard_normal(2 * T)
                          + 1j * rng.standard_normal(2 * T))
                         .astype(np.complex64))
    y1, st = ch.apply(None, ch.init_state(), x[:T])
    y2, _ = ch.apply(None, st, x[T:])
    yall, _ = ch.apply(None, ch.init_state(), x)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=-1).numpy(),
                               yall.numpy(), rtol=1e-5, atol=1e-5)


def test_channel_freqs():
    ch = PolyphaseChannelizer(64_000.0, 8, device="cpu")
    np.testing.assert_allclose(
        ch.channel_freqs(),
        [0, 8000, 16000, 24000, 32000, -24000, -16000, -8000])


def test_device_rule_and_bad_blocks():
    """A default channelizer runs on the card (without one it raises at
    first use); a block that is not one stream of a multiple of M raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PolyphaseChannelizer(FS, 64).init_state()
    ch = PolyphaseChannelizer(FS, 64, device="cpu")
    with pytest.raises(ValueError):
        ch.apply(None, ch.init_state(), torch.zeros(100,
                                                    dtype=torch.complex64))
    with pytest.raises(ValueError):
        ch.apply_planes(ch.init_state(), torch.zeros((2, 640),
                                                     dtype=torch.complex64))
