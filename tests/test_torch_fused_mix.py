"""K11 and the shared-VFO fallback front end against the JAX package.

K11's plain version (``fused_mix_ref``) is held against both fused-mix
Pallas bodies in interpret mode at >= 100 dB (float32; the bodies
accumulate the taps in another order): ``fused_mix_decim_apply`` (the
pre-twiddle sums, rotated here by K11's own twiddle, as the JAX package's
XLA route rotates them) at C = 4 and 8, and ``fused_mix_decim_planes``
(the twiddle in the kernel, C a multiple of 8) at C = 8, each at K = 31
and 34 (the 10 MS/s and the 2.4 MS/s NFM stage-0 filters).  The plane body's
twiddle steps the float32 ω_dec over 256-output blocks, K11's (the XLA
route's ``rotor``) over 1 024: where |ω_dec| nears π the rounding of
ω_dec, times those steps, limits the two forms' agreement to ~90 dB.  So
the twiddled form is held at 100 dB with the channels within ±10 kHz of
the centre, and across the band each form at 85 dB from a float64
twiddle and from each other.

The port's fallback front end (``SharedRxVFOBank`` where K1 cannot take
the chain: K11, then one K8 per later stage) is held at >= 80 dB on the
IF and every state leaf, over three blocks with a retune before the
third, against the two JAX routes for such chains: the plane pipeline
(``build_plane_pipeline(bank, 8, interpret=True)``, NFM at 10 MS/s) and
the per-stage route of ``SharedRxVFOBank.apply`` (C = 4, CW at
2.4 MS/s)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.rx_vfo import SharedRxVFOBank as JaxBank
from sdrplusplusbrown_tpu.ops import pallas_fir
from sdrplusplusbrown_tpu.ops.plane_frontend import (BS, SUP,
                                                     build_plane_pipeline)
from sdrplusplusbrown_tpu_torch.models.rx_vfo import SharedRxVFOBank
from sdrplusplusbrown_tpu_torch.ops import fused_frontend
from sdrplusplusbrown_tpu_torch.ops.fused_frontend import fused_params
from sdrplusplusbrown_tpu_torch.ops.xlator import _TWO_PI, fmod_floor, rotor

from torch_parity import assert_state_close, planes, port_f32_handoff, \
    snr_db  # noqa: F401

D = 4
T = 16_384
MIN_DB = 100.0
BANK_DB = 80.0


def _inputs(C, K, seed, span=4.5e6):
    """Wideband planes, a raw tail, float32 taps and fused params for C
    channels (offsets across ±``span`` of a 10 MS/s band)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)) * 0.3
    tail = (rng.standard_normal(K - 1) + 1j * rng.standard_normal(K - 1)) * 0.3
    h = np.hanning(K + 2)[1:-1] / K
    offs = np.linspace(-span, 0.98 * span, C) + 917.0
    p = fused_params(offs, 10e6, D)
    phase = rng.uniform(-np.pi, np.pi, C).astype(np.float32)
    return (x.astype(np.complex64), tail.astype(np.complex64),
            h.astype(np.float32), p, phase)


def _port(x, tail, h, p, phase):
    xr, xi = planes(x)
    tr, ti = planes(tail)
    return fused_frontend.fused_mix_ref(
        xr, xi, tr, ti, torch.from_numpy(h), D, p["omega"],
        torch.from_numpy(phase), p["omega_dec"], p["omega_dec_span"]).numpy()


def _packed_taps(h, omega):
    """The JAX package's packed channel taps [2C, 2K]
    (ops/fused_frontend.py there)."""
    k = jnp.arange(h.shape[0], dtype=jnp.float32)
    ang = jnp.asarray(omega)[:, None] * k[None, :]
    gr = jnp.asarray(h)[None, :] * jnp.cos(ang)
    gi = jnp.asarray(h)[None, :] * jnp.sin(ang)
    return jnp.concatenate([jnp.concatenate([gr, -gi], axis=1),
                            jnp.concatenate([gi, gr], axis=1)], axis=0)


def _pre_twiddle(x, tail, h, p):
    """The JAX pre-twiddle body's sums [C, M] complex."""
    ext = jnp.concatenate([jnp.asarray(tail), jnp.asarray(x)])
    return np.asarray(pallas_fir.fused_mix_decim_apply(
        ext, _packed_taps(h, p["omega"].numpy()), D, interpret=True))


def _rotated(pre, K, p, phase):
    """``pre`` [C, M] rotated by K11's twiddle (ops/fused_frontend.py:
    phase0, then the XLA route's ``rotor``) → [2C, M] re/im rows."""
    om, M = p["omega"], pre.shape[-1]
    phase0 = fmod_floor(torch.from_numpy(phase) - om * float(K - 1) + np.pi,
                        _TWO_PI) - np.pi
    y = torch.from_numpy(np.array(pre)) * rotor(
        phase0, p["omega_dec"], p["omega_dec_span"], M)
    return torch.cat([y.real, y.imag]).numpy()


@pytest.mark.parametrize("K", [31, 34])
@pytest.mark.parametrize("C", [4, 8])
def test_k11_plain_matches_fused_mix_kernel(C, K):
    x, tail, h, p, phase = _inputs(C, K, seed=C + K)
    want = _rotated(_pre_twiddle(x, tail, h, p), K, p, phase)
    got = _port(x, tail, h, p, phase)
    assert got.shape == (2 * C, T // D)
    s = snr_db(want, got)
    assert s >= MIN_DB, s


def _plane_kernel(x, tail, h, p, phase, K, C):
    """The JAX plane kernel's twiddled stage-0 output [2C, M], its input
    built as the JAX plane pipeline builds it."""
    M = T // D
    pad_k = -(-(K - 1) // 1024) * 1024
    m_pad = -(-M // SUP) * SUP
    ext = np.concatenate([tail, x])
    off0 = pad_k - (K - 1)
    Lp = -(-(off0 + m_pad * D + pad_k + 1024) // 1024) * 1024
    zt = np.zeros(Lp - off0 - ext.shape[0], np.float32)
    zf = np.zeros(off0, np.float32)
    xf = np.concatenate([zf, ext.real, zt, zf, ext.imag, zt])
    om = p["omega"].numpy()
    phase0 = np.asarray(jnp.mod(jnp.asarray(phase) - jnp.asarray(om)
                                * jnp.float32(K - 1) + np.pi,
                                2 * np.pi) - np.pi)
    n_super = m_pad // SUP
    ii = np.arange(-1, n_super, dtype=np.float32)
    bb = np.arange(SUP // BS, dtype=np.float32)
    base = (jnp.asarray(phase0)[:, None, None]
            + jnp.asarray(p["omega_dec_sup"].numpy())[:, None, None]
            * ii[None, :, None]
            + jnp.asarray(p["omega_dec_bs"].numpy())[:, None, None]
            * bb[None, None, :]).reshape(C, -1)
    out = np.asarray(pallas_fir.fused_mix_decim_planes(
        jnp.asarray(xf), _packed_taps(h, om), D,
        jnp.asarray(p["omega_dec"].numpy())[:, None], base, m_pad, 128,
        jnp.zeros((2 * C, 128), jnp.float32), interpret=True))
    return out[:, SUP:SUP + M]


@pytest.mark.parametrize("K", [31, 34])
def test_k11_plain_matches_fused_mix_planes_kernel(K):
    """The twiddled form against the plane kernel's in-kernel twiddle,
    channels within ±10 kHz of the centre."""
    args = _inputs(8, K, seed=K, span=10e3)
    s = snr_db(_plane_kernel(*args, K, 8), _port(*args))
    assert s >= MIN_DB, s


def test_k11_twiddle_across_the_band():
    """Channels across ±4.5 MHz: K11's and the plane body's twiddled
    outputs, each against the JAX pre-twiddle body's sums rotated by a
    float64 twiddle and against each other, >= 85 dB."""
    K, C = 31, 8
    args = _inputs(C, K, seed=5)
    x, tail, h, p, phase = args
    pre = _pre_twiddle(x, tail, h, p).astype(np.complex128)
    om = p["omega"].numpy().astype(np.float64)
    ph0 = np.mod(phase - om * (K - 1) + np.pi, 2 * np.pi) - np.pi
    offs = np.linspace(-4.5e6, 0.98 * 4.5e6, C) + 917.0
    om_d = -offs * 2 * np.pi / 10e6 * D
    exact = pre * np.exp(1j * (ph0[:, None] + om_d[:, None]
                               * np.arange(T // D)))
    exact = np.concatenate([exact.real, exact.imag])
    port, plane = _port(*args), _plane_kernel(*args, K, C)
    s = (snr_db(exact, port), snr_db(exact, plane), snr_db(plane, port))
    assert min(s) >= 85.0, s


def _nfm_iq(n, fs, offsets, seed):
    """An NFM carrier (1 kHz tone, 2 kHz deviation) on each offset, plus
    a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    ph = 2 * np.pi * 2000.0 * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for o in offsets:
        x = x + 0.2 * np.exp(1j * (2 * np.pi * o * t + ph))
    return x.astype(np.complex64)


def _run_bank(fs, if_rate, bw, C, offs, retune, Tb, jax_step):
    """Three blocks (the third retuned) through the port's bank and
    ``jax_step``; IF and state held at BANK_DB in every block."""
    jb = JaxBank(fs, if_rate, bw)
    pb = SharedRxVFOBank(fs, if_rate, bw, device="cpu")
    assert pb.route == "K11" and Tb % pb.in_multiple == 0
    x = _nfm_iq(3 * Tb, fs, np.concatenate([offs, retune]), seed=C)
    js, ps = jb.init_state(C), pb.init_state(C)
    for b in range(3):
        o = offs if b < 2 else retune
        xb = x[b * Tb:(b + 1) * Tb]
        jy, js = jax_step(jb, jb.make_params(o), js, jnp.asarray(xb))
        py, ps = pb.apply(pb.make_params(o), ps, planes(xb), raw=False)
        jy = np.asarray(jy)
        assert py.shape == jy.shape and py.dtype == torch.complex64
        s = snr_db(jy, py.numpy())
        assert s >= BANK_DB, (b, s)
        assert_state_close(js, ps, BANK_DB)


def test_fallback_matches_plane_pipeline():
    """NFM at 10 MS/s, C = 8: K11 + K8 against the JAX plane kernels."""
    offs = np.linspace(-4e6, 4e6, 8) + 917.0

    def step(jb, params, state, x):
        pipe = build_plane_pipeline(jb, 8, interpret=True)
        assert pipe is not None
        return pipe.apply(params["fused"], state, x)
    _run_bank(10e6, 50e3, 12.5e3, 8, offs, offs + 20e3, 32_000, step)


def test_fallback_matches_per_stage_route():
    """CW at 2.4 MS/s, C = 4 (neither the JAX mono kernel nor its plane
    pipeline takes it): K11 + K8 against the JAX per-stage route."""
    offs = np.array([-7e5, -2e5, 3e5, 8e5]) + 917.0

    def step(jb, params, state, x):
        assert jb._mono_pipe(4) is None and jb._plane_pipe(4) is None
        return jb.apply(params, state, x)
    # 0.2 s blocks: the CW chain's filters delay its IF by ~0.2 s
    _run_bank(2.4e6, 3e3, 200.0, 4, offs, offs + 1e3, 480_000, step)


def test_k1_route_is_chosen_from_the_geometry():
    """The route is fixed when the bank is built: K1 where the JAX window
    solver takes the chain, the fallback elsewhere."""
    for fs, if_rate, bw, route in ((2.4e6, 50e3, 12.5e3, "K1"),
                                   (2.4e6, 15e3, 10e3, "K1"),
                                   (2.4e6, 24e3, 2.8e3, "K1"),
                                   (2.4e6, 3e3, 200.0, "K11"),
                                   (10e6, 50e3, 12.5e3, "K11"),
                                   (10e6, 15e3, 10e3, "K11"),
                                   (10e6, 24e3, 2.8e3, "K11")):
        pb = SharedRxVFOBank(fs, if_rate, bw, device="cpu")
        assert pb.route == route, (fs, if_rate)
        jb = JaxBank(fs, if_rate, bw)
        assert (jb._mono_pipe(4) is not None) == (route == "K1")
