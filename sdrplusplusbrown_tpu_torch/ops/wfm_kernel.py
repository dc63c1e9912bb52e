"""WFM demodulator, stereo section and audio polyphase — kernels K2, K10
and K3 with their plain versions (counterpart of
sdrplusplusbrown_tpu/ops/wfm_kernel.py and ops/pallas_wfm.py).

K2 (``wfm_demod``): the IF planes [2C, ≥m_if] → discriminator → MPX
halfbands → stereo section (pilot band-pass, normalize VCO with the
one-sample PLL lag, L±R matrix) → L/R planes [2C, m_mpx] in the handoff
dtype, and the carried state it advances (quad, mpx_decim, mpx_hist),
computed by the kernels themselves.  The stereo section uses the
identities of the TPU kernel (ops/pallas_wfm.py there): the lagged pilot
is a window offset, u = conj(pilot_phase_corr)² folds the phase
correction, and the ``mpx_hist`` state (last K MPX samples) covers the
pilot FIR, its lag and the L+R delay d ≤ K.

K10 (``wfm_stereo``): K2's stereo section launched alone, the
counterpart of ``_wfm_stereo_kernel`` (ops/pallas_wfm.py there): MPX
[C, T] float32 and ``mpx_hist`` [C, K] → [2, C, T] float32 (L plane, then
R plane), as ``wfm_stereo_apply`` returns it.

K3 (``mpx_audio_poly``): the de-emphasis-folded 48/125 audio polyphase
over the L/R planes → audio [2C, m_aud] float32.

Carried state is rounded to the handoff dtype at the same places as the
JAX kernels (their state tails ride device memory in that dtype).
Dispatch follows the input: CPU tensors run the ``*_ref`` versions, CUDA
tensors launch the kernels (csrc/wfm_demod.cu, csrc/mpx_poly.cu) or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .demod import quad_planes
from .precision import get_handoff_dtype, round_to
from .fir_kernel import SMS, fir_plan, poly_rows

#: storage dtypes the kernels read and write
_STORAGE = (torch.float32, torch.bfloat16)


def _f32_taps(a, dtype, device) -> torch.Tensor:
    """numpy taps → float32 tensor rounded to the storage ``dtype``."""
    return round_to(torch.tensor(np.asarray(a, np.float32)), dtype) \
        .to(device).contiguous()


class WFMDemodPipeline:
    """K2 configuration built from a BroadcastFM demod."""

    def __init__(self, dem):
        if dem.pll_mode != "normalize" or not dem.stereo \
                or not dem.mpx_stages:
            raise NotImplementedError(
                "WFM kernel: stereo, normalize pilot only")
        self.inv_dev = float(dem.quad.inv_deviation)
        self.K = int(len(dem.pilot_taps))
        self.d = int(dem.lpr_delay.delay)
        if self.d > self.K:
            raise NotImplementedError("L+R delay longer than the pilot FIR")
        u = np.conj(complex(dem.pilot_phase_corr)) ** 2
        self.ur = float(np.float32(np.real(u)))
        self.ui2 = float(np.float32(2.0 * np.imag(u)))
        for stg in dem.mpx_stages:
            if stg.decim != 2 or stg._complex_taps:
                raise NotImplementedError("MPX stage is not a real halfband")
        self.hb_taps = [np.asarray(s.taps, np.float32) for s in dem.mpx_stages]
        self.pilot = np.asarray(dem.pilot_taps)
        self._dev_taps = {}

    def taps(self, device, dtype):
        """([halfband taps], pilot re, pilot im) float32 device tensors
        rounded to the storage ``dtype``."""
        key = (str(device), dtype)
        if key not in self._dev_taps:
            self._dev_taps[key] = (
                [_f32_taps(h, dtype, device) for h in self.hb_taps],
                _f32_taps(np.real(self.pilot), dtype, device),
                _f32_taps(np.imag(self.pilot), dtype, device))
        return self._dev_taps[key]

    def apply(self, state, iq, m_if: int):
        """iq: [2C, ≥m_if] IF planes (re rows, im rows) → (L/R planes
        [2C, m_mpx] in the handoff dtype, new_state with quad / mpx_decim /
        mpx_hist updated and every other key passed through)."""
        lr, quad, hb_tails, hist = wfm_demod(
            self, iq, m_if, state["quad"].contiguous(),
            [t.float().contiguous() for t in state["mpx_decim"]],
            state["mpx_hist"].float().contiguous(), get_handoff_dtype())
        new_state = dict(state)
        new_state.update(quad=quad, mpx_decim=hb_tails, mpx_hist=hist)
        return lr, new_state


def _check_wfm(pipe, iq, m_if, quad, hb_tails, hist):
    C = iq.shape[0] // 2
    if iq.dim() != 2 or iq.shape[0] != 2 * C or iq.shape[1] < m_if:
        raise ValueError(f"IF planes shape {tuple(iq.shape)}")
    if m_if % (1 << len(pipe.hb_taps)):
        raise ValueError(f"m_if {m_if} not a multiple of the MPX decimation")
    if tuple(quad.shape) != (C, 1) or not quad.is_complex():
        raise ValueError(f"quad state {tuple(quad.shape)} {quad.dtype}")
    if len(hb_tails) != len(pipe.hb_taps):
        raise ValueError(f"{len(hb_tails)} halfband tails")
    for h, t in zip(pipe.hb_taps, hb_tails):
        if tuple(t.shape) != (C, len(h) - 1):
            raise ValueError(f"halfband tail shape {tuple(t.shape)}")
    if tuple(hist.shape) != (C, pipe.K):
        raise ValueError(f"mpx_hist shape {tuple(hist.shape)}")
    return C


def wfm_demod_ref(pipe, iq, m_if, quad, hb_tails, hist, out_dtype):
    """Plain PyTorch K2: the carried state ``quad`` (complex [C, 1]),
    ``hb_tails`` ([C, K_i − 1] each) and ``hist`` ([C, K]) are read
    rounded to ``out_dtype``, the handoff dtype; returns (L/R planes [2C,
    m_mpx] ``out_dtype``, new quad complex64 [C, 1], [new halfband tails],
    new mpx_hist), the state float32 with values rounded to
    ``out_dtype``."""
    lr, quad, tails, hist, _ = _wfm_demod_ref(pipe, iq, m_if, quad,
                                              hb_tails, hist, out_dtype)
    return lr, quad, tails, hist


def _wfm_demod_ref(pipe, iq, m_if, quad, hb_tails, hist, out_dtype):
    """``wfm_demod_ref``'s five results: those four, then [the
    discriminator's output, each halfband's]."""
    C = _check_wfm(pipe, iq, m_if, quad, hb_tails, hist)
    hbs, hr, hi = pipe.taps(iq.device, out_dtype)
    x = iq[:, :m_if].float()
    er, ei = x[:C], x[C:]
    q = round_to(quad[:, 0], out_dtype)
    erp = torch.cat([q.real.float()[:, None], er[:, :-1]], dim=1)
    eip = torch.cat([q.imag.float()[:, None], ei[:, :-1]], dim=1)
    y = quad_planes(er, ei, erp, eip, pipe.inv_dev)
    last = round_to(x[:, m_if - 1], out_dtype)
    new_quad = torch.complex(last[:C], last[C:])[:, None]
    outs, new_tails = [y], []
    for h, t in zip(hbs, hb_tails):
        ext = torch.cat([round_to(t.float(), out_dtype), y], dim=1)
        new_tails.append(round_to(ext[:, -t.shape[1]:], out_dtype))
        y = poly_rows(ext, h[None, :], 1, 2)
        outs.append(y)
    ext = torch.cat([round_to(hist.float(), out_dtype), y], dim=1)
    new_hist = round_to(ext[:, -pipe.K:], out_dtype)
    lr = _stereo_ref(pipe, y, ext[:, :pipe.K], hr, hi)
    return (lr.reshape(2 * C, -1).to(out_dtype), new_quad, new_tails,
            new_hist, outs)


def _stereo_ref(pipe, mpx, hist, hr, hi):
    """The stereo section in plain PyTorch: MPX [C, m], history [C, K] →
    [2, C, m] float32 (L, R)."""
    m = mpx.shape[1]
    K, d = pipe.K, pipe.d
    ext = torch.cat([hist, mpx], dim=1)
    a = poly_rows(ext[:, :m + K - 1], hr[None, :], 1, 1)
    b = poly_rows(ext[:, :m + K - 1], hi[None, :], 1, 1)
    lpr = ext[:, K - d:K - d + m]
    wsub = (pipe.ur * (a * a - b * b) + pipe.ui2 * (a * b)) \
        / torch.clamp(a * a + b * b, min=1e-20)
    two = 2.0 * wsub
    return torch.stack([lpr * (1.0 + two), lpr * (1.0 - two)])


#: CUDA launches of one ``wfm_demod_kernel`` call (csrc/wfm_demod.cu: the
#: discriminator and first halfband, the second halfband, the stereo
#: section)
WFM_DEMOD_LAUNCHES = 3


@_build.counted_launches
def wfm_demod_kernel(pipe, iq, m_if, quad, hb_tails, hist, out_dtype):
    """K2 on the card (csrc/wfm_demod.cu, three launches, each counted in
    ``launches``); same contract as ``wfm_demod_ref``."""
    return _wfm_demod_launches(pipe, iq, m_if, quad, hb_tails, hist,
                               out_dtype)[:4]


def demod_plan(n_out: int, rows: int) -> dict:
    """The FIR tile's grid for K2's three launches and K10 (csrc/
    wfm_demod.cu): ``P`` = 3 outputs a lane, 8 warps, ``C`` chunks of 32·P
    outputs a block, halved from 4 until the launch has 4 blocks an SM
    (or C = 1).  These launches last a few µs each, the first's staging
    runs the discriminator (~60 operations a sample, more than an
    output's 26 taps) and the stereo section's 159 taps feed two sums an
    output: latency bounds them, and more, smaller blocks than
    ``fir_plan`` gives K8 hide more of it (``scripts/front_end_sweep.py
    --plans`` ranks this choice among a grid of plans for each
    launch)."""
    P = 3
    n_c = -(-n_out // (32 * P))
    C = min(4, n_c)
    while C > 1 and rows * -(-n_c // C) < 4 * SMS:
        C = (C + 1) // 2
    return {"P": P, "C": C, "warps": 8, "grid": (-(-n_c // C), 1, rows)}


def _wfm_demod_launches(pipe, iq, m_if, quad, hb_tails, hist, out_dtype,
                        probe: bool = False):
    """K2's three launches: ``wfm_demod_kernel``'s four results, then [the
    discriminator's output (with ``probe``, else None), the first
    halfband's, the second's (the MPX)]."""
    dev = iq.device
    f32 = torch.float32
    C = _check_wfm(pipe, iq, m_if, quad, hb_tails, hist)
    if out_dtype not in _STORAGE or len(hb_tails) != 2:
        raise ValueError(f"output dtype {out_dtype}, "
                         f"{len(hb_tails)} halfbands")
    hbs, hr, hi = pipe.taps(dev, out_dtype)
    h_bf16 = int(out_dtype == torch.bfloat16)
    new_tails = [torch.empty_like(t) for t in hb_tails]
    mpx0 = torch.empty((C, m_if), dtype=f32, device=dev) if probe else None
    # the discriminator in the first halfband's staging
    K = hbs[0].shape[0]
    y = torch.empty((C, m_if // 2), dtype=f32, device=dev)
    new_quad = torch.empty((C, 1), dtype=torch.complex64, device=dev)
    p = demod_plan(y.shape[1], C)
    _build.launch(
        "sdr_wfm_quad_halfband", dev,
        _build.check(iq, "IF planes", _STORAGE, device=dev),
        int(iq.dtype == torch.bfloat16), iq.shape[1], C, m_if,
        _build.check(quad, "quad state", torch.complex64, device=dev),
        pipe.inv_dev,
        _build.check(hb_tails[0], "halfband tail", f32, device=dev), K - 1,
        _build.check(hbs[0], "halfband taps", f32), K, y.data_ptr(),
        y.shape[1], h_bf16, new_quad.data_ptr(), new_tails[0].data_ptr(),
        None if mpx0 is None else mpx0.data_ptr(), p["P"], p["C"],
        p["warps"])
    outs = [mpx0, y]
    K = hbs[1].shape[0]
    mpx = torch.empty((C, y.shape[1] // 2), dtype=f32, device=dev)
    p = demod_plan(mpx.shape[1], C)
    _build.launch(
        "sdr_wfm_halfband", dev,
        _build.check(hb_tails[1], "halfband tail", f32, device=dev), K - 1,
        h_bf16, y.data_ptr(), y.shape[1],
        _build.check(hbs[1], "halfband taps", f32), K, mpx.data_ptr(),
        mpx.shape[1], C, new_tails[1].data_ptr(), p["P"], p["C"],
        p["warps"])
    outs.append(mpx)
    lr = torch.empty((2 * C, mpx.shape[1]), dtype=out_dtype, device=dev)
    new_hist = torch.empty_like(hist)
    _launch_stereo(pipe, mpx, hist, h_bf16, hr, hi, lr, new_hist)
    return lr, new_quad, new_tails, new_hist, outs


def _launch_stereo(pipe, mpx, hist, h_bf16, hr, hi, out, new_hist):
    """The stereo section (csrc/wfm_demod.cu:sdr_wfm_stereo) on MPX [C, m]
    float32 into ``out`` ([2C, m] float32 or bf16), ``new_hist`` where
    not None; ``demod_plan``'s grid."""
    dev = mpx.device
    f32 = torch.float32
    C, m = mpx.shape
    p = demod_plan(m, C)
    _build.launch(
        "sdr_wfm_stereo", dev, _build.check(mpx, "MPX", f32, device=dev),
        _build.check(hist, "mpx_hist", f32, device=dev), h_bf16, pipe.K,
        pipe.d, m, _build.check(hr, "pilot re", f32),
        _build.check(hi, "pilot im", f32), pipe.ur, pipe.ui2,
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        None if new_hist is None else new_hist.data_ptr(), C, p["P"], p["C"],
        p["warps"])


def wfm_demod(pipe, iq, m_if, quad, hb_tails, hist, out_dtype):
    """K2 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = wfm_demod_kernel if iq.is_cuda else wfm_demod_ref
    return fn(pipe, iq, m_if, quad, hb_tails, hist, out_dtype)


def _check_stereo(pipe, mpx, hist):
    if mpx.dim() != 2 or mpx.dtype != torch.float32 or \
            tuple(hist.shape) != (mpx.shape[0], pipe.K):
        raise ValueError(f"stereo section: MPX {tuple(mpx.shape)} "
                         f"{mpx.dtype}, history {tuple(hist.shape)}")


def wfm_stereo_ref(pipe, mpx, hist):
    """Plain PyTorch K10: MPX [C, T] float32, ``mpx_hist`` [C, K] → [2,
    C, T] float32 (L plane, then R plane)."""
    _check_stereo(pipe, mpx, hist)
    _, hr, hi = pipe.taps(mpx.device, torch.float32)
    return _stereo_ref(pipe, mpx, hist, hr, hi)


@_build.counted
def wfm_stereo_kernel(pipe, mpx, hist):
    """K10 on the card (csrc/wfm_demod.cu:stereo_kernel launched alone
    through ``sdr_wfm_stereo``); same contract as ``wfm_stereo_ref``."""
    _check_stereo(pipe, mpx, hist)
    _, hr, hi = pipe.taps(mpx.device, torch.float32)
    out = torch.empty((2,) + tuple(mpx.shape), dtype=torch.float32,
                      device=mpx.device)
    _launch_stereo(pipe, mpx, hist, 0, hr, hi, out, None)
    return out


def wfm_stereo(pipe, mpx, hist):
    """K10 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = wfm_stereo_kernel if mpx.is_cuda else wfm_stereo_ref
    return fn(pipe, mpx, hist)


class MPXAudioPoly:
    """K3 configuration built from the (de-emphasis-folded) audio
    PolyphaseResampler."""

    def __init__(self, poly):
        self.I, self.D = int(poly.interp), int(poly.decim)
        self.kernel = np.asarray(poly.kernel, np.float32)
        self.hist = poly.tpp - 1
        self._dev_taps = {}

    def taps(self, device, dtype) -> torch.Tensor:
        key = (str(device), dtype)
        if key not in self._dev_taps:
            self._dev_taps[key] = _f32_taps(self.kernel, dtype, device)
        return self._dev_taps[key]

    def apply(self, ars, raw, m_in: int):
        """ars: [2, C, hist] carried input (state["audio_rs"]); raw:
        [2C, ≥m_in] L/R planes → (audio [C, 2, m_aud] float32, new ars)."""
        h_dt = get_handoff_dtype()
        C = ars.shape[1]
        ptail = round_to(torch.cat([ars[0], ars[1]]).float(), h_dt) \
            .contiguous()
        audio = mpx_audio_poly(self, raw, m_in, ptail, h_dt)
        lr = torch.stack([audio[:C], audio[C:]], dim=1)
        t = round_to(torch.cat([ptail, raw[:, :m_in].float()], dim=1)
                     [:, -self.hist:], h_dt)
        return lr, torch.stack([t[:C], t[C:]])


def _check_poly(pipe, raw, m_in, ptail):
    if raw.dim() != 2 or raw.shape[1] < m_in or m_in % pipe.D:
        raise ValueError(f"L/R planes shape {tuple(raw.shape)}, m {m_in}")
    if tuple(ptail.shape) != (raw.shape[0], pipe.hist):
        raise ValueError(f"audio tail shape {tuple(ptail.shape)}")
    return m_in // pipe.D * pipe.I


def mpx_audio_poly_ref(pipe, raw, m_in, ptail, tap_dtype):
    """Plain PyTorch K3: audio [2C, m_aud] float32."""
    _check_poly(pipe, raw, m_in, ptail)
    ker = pipe.taps(raw.device, tap_dtype)
    ext = torch.cat([ptail, raw[:, :m_in].float()], dim=1)
    return poly_rows(ext, ker, pipe.I, pipe.D)


@_build.counted
def mpx_audio_poly_kernel(pipe, raw, m_in, ptail, tap_dtype):
    """K3 on the card (csrc/mpx_poly.cu, the FIR tile of K8 on
    ``fir_plan``'s grid); same contract as ``mpx_audio_poly_ref``."""
    dev = raw.device
    f32 = torch.float32
    m_aud = _check_poly(pipe, raw, m_in, ptail)
    ker = pipe.taps(dev, tap_dtype)
    p = fir_plan(pipe.I, pipe.D, ker.shape[1], m_aud, raw.shape[0], 1)
    out = torch.empty((raw.shape[0], m_aud), dtype=f32, device=dev)
    _build.launch(
        "sdr_mpx_poly", dev, _build.check(ptail, "audio tail", f32,
                                          device=dev), pipe.hist,
        _build.check(raw, "L/R planes", _STORAGE, device=dev),
        int(raw.dtype == torch.bfloat16), raw.shape[1],
        _build.check(ker, "audio kernel", f32), pipe.I, pipe.D,
        ker.shape[1], out.data_ptr(), m_aud, raw.shape[0], p["P"], p["G"],
        p["C"], p["warps"])
    return out


def mpx_audio_poly(pipe, raw, m_in, ptail, tap_dtype):
    """K3 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = mpx_audio_poly_kernel if raw.is_cuda else mpx_audio_poly_ref
    return fn(pipe, raw, m_in, ptail, tap_dtype)
