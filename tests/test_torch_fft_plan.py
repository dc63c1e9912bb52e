"""The spectrum FFT's plan, twiddle table and index arithmetic, on the CPU
(csrc/spectrum_fft.cu runs only on the card).

``stockham`` and ``model_fft`` model the kernels' schedule in numpy: the
same Stockham radix passes (16 while 16 divides what is left, then 2, 4 or
8), the same register DFT split (n = 4·n1 + n2), the same twiddle indices
into the float32 tables, the same natural-order bins.  Run in float64 on
that table, the model agrees with ``np.fft.fft`` to >= 120 dB, and its dB
spectra agree with the JAX ``fft_power_db_planes`` in interpret mode
within the spectra bars."""

import numpy as np
import pytest

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops.pallas_fft import \
    fft_power_db_planes as jax_fft_db
from sdrplusplusbrown_tpu_torch.ops import fft_kernel

from torch_parity import assert_spectra_close, snr_db

SIZES = [1 << lg for lg in range(8, 19)]

# exp(−2πi·m/16) as the kernel's literals give it (csrc: w16)
_C, _S, _H = (np.float32(0.92387953251128674), np.float32(0.38268343236508977),
              np.float32(0.70710678118654752))
W16 = np.array([1, _C - 1j * _S, _H - 1j * _H, _S - 1j * _C, -1j,
                -_S - 1j * _C, -_H - 1j * _H, -_C - 1j * _S, -1,
                -_C + 1j * _S, -_H + 1j * _H, -_S + 1j * _C, 1j,
                _S + 1j * _C, _H + 1j * _H, _C + 1j * _S])


def dft_reg(v):
    """The kernel's register DFT of v [R, ...] (R = 2, 4, 8, 16), natural
    order in and out: R >= 8 splits n = 4·n1 + n2 (radix R/4 over n1,
    W_R^(n2·k1), radix 4 over n2; bin k1 + (R/4)·k2 from v[4·k1 + k2])."""
    R = v.shape[0]
    if R == 2:
        return np.stack([v[0] + v[1], v[0] - v[1]])
    if R == 4:
        s02, d02 = v[0] + v[2], v[0] - v[2]
        s13, d13 = v[1] + v[3], -1j * (v[1] - v[3])
        return np.stack([s02 + s13, d02 + d13, s02 - s13, d02 - d13])
    q = R // 4
    a = dft_reg(v.reshape((q, 4) + v.shape[1:]))       # [k1, n2, ...]
    tw = W16[(16 // R) * np.outer(np.arange(q), np.arange(4)) % 16]
    a = a * tw.reshape((q, 4) + (1,) * (v.ndim - 1))
    b = np.stack([dft_reg(a[k1]) for k1 in range(q)])  # [k1, k2, ...]
    return b.transpose((1, 0) + tuple(range(2, b.ndim))).reshape(v.shape)


def stockham(x, tab, ts):
    """The kernel's passes over x [..., L] (csrc: fft_passes): group j
    reads x[j + r·L/R] times tab[r·k·(L/(Ns·R))·ts], k = j mod Ns, runs the
    register DFT and writes bin r to (j / Ns)·Ns·R + k + r·Ns."""
    L = x.shape[-1]
    a, ns = x.astype(np.complex128), 1
    for R in fft_kernel.radices(L):
        j = np.arange(L // R)
        k = j & (ns - 1)
        r = np.arange(R)[:, None]
        v = np.moveaxis(a[..., j + r * (L // R)], -2, 0)    # [R, ..., L/R]
        idx = r * k * (L // (ns * R)) * ts
        assert idx.max() < tab.shape[0]
        v = v * tab[idx].reshape((R,) + (1,) * (v.ndim - 2) + (L // R,))
        v = dft_reg(v)
        out = np.empty_like(a)
        out[..., (j // ns) * ns * R + k + r * ns] = np.moveaxis(v, 0, -2)
        a, ns = out, ns * R
    return a


def model_fft(x, N):
    """The route ``plan`` picks for one N-point frame x."""
    tab = fft_kernel.twiddles(N, "cpu").numpy().astype(np.float64)
    tab = tab[:, 0] + 1j * tab[:, 1]
    p = fft_kernel.plan(N, 1)
    if p["route"] == "one-pass":
        return stockham(x, tab, 1)
    N1, N2 = p["sizes"]
    cols = stockham(x.reshape(N1, N2).T, tab, N2)          # [n2, k1]
    tw4 = fft_kernel.four_step_twiddles(N1, N2, "cpu").numpy()
    tw4 = (tw4[:, 0] + 1j * tw4[:, 1].astype(np.float64)).reshape(N1, N2)
    C = cols.T * tw4                                       # C[k1, n2]
    rows = stockham(C, tab, N1)                            # [k1, k2]
    return rows.T.reshape(N)                               # k1 + N1·k2


@pytest.mark.parametrize("N", SIZES)
def test_twiddle_table_is_rounded_once(N):
    tab = fft_kernel.twiddles(N, "cpu")
    assert tab.shape == (N, 2) and fft_kernel.twiddles(N, "cpu") is tab
    ref = np.exp(-2j * np.pi * np.arange(N) / N)
    got = tab.numpy().astype(np.float64)
    for part, want in ((got[:, 0], ref.real), (got[:, 1], ref.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(part - want) <= ulp)


@pytest.mark.parametrize("N", [n for n in SIZES if n > 4096])
def test_four_step_twiddles_index_the_table_mod_n(N):
    """Entry k1·N2 + n2 is the table's entry n2·k1 mod N, bit for bit."""
    N1, N2 = fft_kernel.plan(N, 1)["sizes"]
    tw4 = fft_kernel.four_step_twiddles(N1, N2, "cpu")
    assert tw4.shape == (N, 2)
    assert fft_kernel.four_step_twiddles(N1, N2, "cpu") is tw4
    tab = fft_kernel.twiddles(N, "cpu").numpy()
    k1, n2 = np.meshgrid(np.arange(N1), np.arange(N2), indexing="ij")
    np.testing.assert_array_equal(tw4.numpy(),
                                  tab[(n2 * k1).reshape(-1) % N])


@pytest.mark.parametrize("N", SIZES)
def test_plan_fits_the_card(N):
    p = fft_kernel.plan(N, 2)
    assert p["route"] == ("one-pass" if N <= 4096 else "four-step")
    assert int(np.prod(p["sizes"])) == N
    for L, rad in zip(p["sizes"], p["radices"]):
        assert int(np.prod(rad)) == L and set(rad) <= {2, 4, 8, 16}
        assert list(rad[:-1]) == [16] * (len(rad) - 1)
    assert [ln["entry"] for ln in p["launches"]] == (
        ["sdr_fft_frames"] if N <= 4096 else ["sdr_fft_cols", "sdr_fft_rows"])
    n_seq = [2] if N <= 4096 else [2 * p["sizes"][1], 2 * p["sizes"][0]]
    for ln, L, n in zip(p["launches"], p["sizes"], n_seq):
        per = ln["per_block"]
        assert per & (per - 1) == 0 and ln["threads"] == per * L // 16 <= 256
        assert ln["smem"] == 8 * (L + L // 16) * per <= 232_448
        assert ln["blocks"] * per >= n > (ln["blocks"] - 1) * per


def test_plan_fills_the_card():
    """Two frames of 65 536 or 262 144 points: >= 132 blocks a launch;
    channelizer64's 2 048 frames of 1 024: one launch of 512 blocks."""
    for N in (65_536, 262_144):
        assert [ln["blocks"] >= 132
                for ln in fft_kernel.plan(N, 2)["launches"]] == [True, True]
    (ln,) = fft_kernel.plan(1024, 2048)["launches"]
    assert (ln["blocks"], ln["threads"]) == (512, 256)
    with pytest.raises(ValueError):
        fft_kernel.plan(3000, 1)
    with pytest.raises(ValueError):
        fft_kernel.plan(128, 1)


@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 65536])
def test_schedule_model_matches_numpy_fft(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    assert snr_db(np.fft.fft(x), model_fft(x, N)) >= 120.0


def test_schedule_model_matches_jax_fft_power_db():
    """The model's dB spectra of float32 frames against the JAX function
    in interpret mode (K4r's shapes, small)."""
    N, F = 1024, 3
    rng = np.random.default_rng(5)
    n = np.arange(F * N)
    z = np.exp(2j * np.pi * 37.3 * n / N) + 0.05 * (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    xr = z.real.astype(np.float32).reshape(F, N)
    xi = z.imag.astype(np.float32).reshape(F, N)
    want = np.asarray(jax_fft_db(jnp.asarray(xr), jnp.asarray(xi), N,
                                 interpret=True))
    X = np.stack([model_fft(xr[f] + 1j * xi[f].astype(np.float64), N)
                  for f in range(F)])
    p = np.abs(X) ** 2 / float(N) ** 2
    got = (10 * np.log10(np.maximum(p, 1e-30))).astype(np.float32)
    assert_spectra_close(want, got)
