"""NFM demod + audio — kernel K7 and its plain version (counterpart of
sdrplusplusbrown_tpu/ops/demod_kernel.py:_demod_kernel).

Per channel c, over the raw IF buffer [2C, ≥m_if] (re rows over im rows,
in the handoff storage dtype):

  1. the squelch gate multiplies the IF (a closed channel's IF, and so
     its carried sample, is zero);
  2. the discriminator d[n] = atan2(Im, Re)(x[n]·conj(x[n−1]))·inv_dev
     with the TPU kernel's degree-8 minimax atan2 (``_ATAN_C``, 2.4e-7 rad
     from the true angle) in both the kernel and the plain version;
     subnormal products count as zero (XLA:CPU and the TPU flush them)
     and a zero product gives exact silence;
  3. the 304-tap audio low-pass and the 24/25 AF polyphase resampler.

IF columns past m_if count as zero, so the untrimmed audio
[C, n_super·adv_aud] matches the JAX kernel's padded output too.  One
launch covers any C (the TPU walked channel chunks for its VMEM cap).
Taps and carried tails are rounded to the handoff dtype where the JAX
kernel rounds them.

Dispatch follows the input: CPU tensors run ``fm_audio_ref``; CUDA
tensors launch ``fm_audio_kernel`` (csrc/fm_audio.cu: the discriminator
in the audio FIR's staging, both filters on the polyphase FIR tile, in
``fm_plan``'s two launches) or raise.  Both need m_if >= 1.
"""

from __future__ import annotations

import math
from math import gcd

import numpy as np
import torch

from ..kernels import _build
from .precision import get_handoff_dtype, round_to
from .fir_kernel import SMS, fir_plan, poly_rows, tile_smem

# atan(z) = z·P(z²) on [0, 1], degree-8 P (the JAX kernel's coefficients)
_ATAN_C = (0.9999999055480192, -0.33332657866595233, 0.19986537719204336,
           -0.1416433501814265, 0.10507325890466393, -0.072479633550002,
           0.039899708900995264, -0.014458788993819372,
           0.0024682698535998596)

_TINY = float(np.finfo(np.float32).tiny)
_STORAGE = (torch.float32, torch.bfloat16)


def _f32(v: float) -> float:
    return float(np.float32(v))


def atan2_poly(im: torch.Tensor, re: torch.Tensor) -> torch.Tensor:
    """The minimax atan2, one float32 rounding per operation; 0 where
    both arguments are zero."""
    a, b = im.abs(), re.abs()
    mx = torch.maximum(a, b)
    z = torch.minimum(a, b) / torch.where(mx == 0, torch.ones_like(mx), mx)
    z2 = z * z
    p = torch.full_like(z, _f32(_ATAN_C[8]))
    for c in reversed(_ATAN_C[:8]):
        p = p * z2 + _f32(c)
    t = z * p
    t = torch.where(a > b, _f32(np.pi / 2) - t, t)
    t = torch.where(re < 0, _f32(np.pi) - t, t)
    t = torch.where(im < 0, -t, t)
    return torch.where((re == 0) & (im == 0), torch.zeros_like(t), t)


class FMAudioPipeline:
    """K7 configuration built from a Radio's FMDemod and AF
    RationalResampler (a lone 24/25 polyphase stage at 50 → 48 kHz)."""

    def __init__(self, demod, af_resamp):
        nb = af_resamp.chain.named_blocks if af_resamp is not None else []
        if len(nb) != 1 or nb[0][0] != "resamp" or demod.fir.decim != 1:
            raise NotImplementedError("demod+audio kernel: an audio FIR "
                                      "and one polyphase stage")
        poly = nb[0][1]
        self.inv_dev = float(demod.quad.inv_deviation)
        self.hf = np.asarray(demod.fir.taps, np.float32)
        self.I, self.D = int(poly.interp), int(poly.decim)
        self.kernel = np.asarray(poly.kernel, np.float32)       # [I, kw]
        self.histF = len(self.hf) - 1
        self.histP = poly.tpp - 1
        # the TPU kernel's step: adv_aud audio samples per adv_if IF ones
        mt = 128 // gcd(self.I, 128)
        tile = mt * self.I
        lcm_a = tile * 128 // gcd(tile, 128)
        for j in range(1, 65):
            adv_aud = j * lcm_a
            adv_if, r = divmod(adv_aud * self.D, self.I)
            if not r and adv_if % 128 == 0 and adv_if % (mt * self.D) == 0:
                break
        else:
            raise NotImplementedError("no step geometry for this resampler")
        self.adv_if, self.adv_aud = adv_if, adv_aud
        self._dev = {}

    def plan(self, m_if: int) -> dict:
        if (m_if * self.I) % self.D:
            raise ValueError(f"IF length {m_if} not a multiple of "
                             f"{self.D // gcd(self.I, self.D)}")
        m_aud = m_if * self.I // self.D
        n_super = -(-m_aud // self.adv_aud)
        return {"m_aud": m_aud, "n_aud": n_super * self.adv_aud,
                "n_if": n_super * self.adv_if}

    def taps(self, device, dtype):
        """(audio FIR [Kf], polyphase kernel [I, kw]) float32 device
        tensors rounded to the storage ``dtype``."""
        key = (str(device), dtype)
        if key not in self._dev:
            self._dev[key] = tuple(
                round_to(torch.from_numpy(a), dtype).to(device).contiguous()
                for a in (self.hf, self.kernel))
        return self._dev[key]

    def apply(self, gate, dstate, astate, iq, m_if: int,
              raw_audio: bool = False, dtype=None):
        """iq: raw [2C, ≥m_if] IF buffer; gate [C] float32 or None →
        (audio [C, m_aud] float32 — or with ``raw_audio`` (audio
        [C, n_aud] in ``dtype``, m_aud) — new demod state {"quad", "fir"},
        new AF state {"resamp"}).  ``dtype`` is the storage of the taps,
        the carried tails and the raw audio: the handoff dtype by default,
        float32 where the JAX route runs FMDemod in float32."""
        h_dt = get_handoff_dtype() if dtype is None else dtype
        C = iq.shape[0] // 2
        if gate is None:
            gate = torch.ones(C, dtype=torch.float32, device=iq.device)
        q = dstate["quad"][:, 0]
        qprev = round_to(torch.cat([q.real, q.imag]).float(), h_dt)
        ftail = round_to(dstate["fir"].float(), h_dt).contiguous()
        ptail = round_to(astate["resamp"].float(), h_dt).contiguous()
        audio, nq, nf, np_ = fm_audio(
            self, iq, m_if, gate.contiguous(), qprev.contiguous(), ftail,
            ptail, h_dt if raw_audio else torch.float32, h_dt)
        m_aud = self.plan(m_if)["m_aud"]
        y = (audio, m_aud) if raw_audio else audio[:, :m_aud]
        return (y, {"quad": torch.complex(nq[:C], nq[C:])[:, None],
                    "fir": nf}, {"resamp": np_})


def _check_fm(pipe, iq, m_if, gate, qprev, ftail, ptail):
    C = iq.shape[0] // 2
    if m_if < 1:
        raise ValueError(f"IF length {m_if}: K7 needs at least one sample")
    if iq.dim() != 2 or iq.shape[0] != 2 * C or iq.shape[1] < m_if:
        raise ValueError(f"IF buffer shape {tuple(iq.shape)}, m_if {m_if}")
    if tuple(gate.shape) != (C,) or tuple(qprev.shape) != (2 * C,):
        raise ValueError("gate / quad state shapes")
    if tuple(ftail.shape) != (C, pipe.histF) or \
            tuple(ptail.shape) != (C, pipe.histP):
        raise ValueError("audio tail shapes")
    return C, pipe.plan(m_if)


def fm_audio_ref(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
                 tail_dtype):
    """Plain PyTorch K7: (audio [C, n_aud] ``out_dtype``, next-call
    quad sample [2C], audio FIR tail [C, histF], polyphase tail
    [C, histP]; the state rounded to ``tail_dtype``)."""
    return _fm_audio_ref(pipe, iq, m_if, gate, qprev, ftail, ptail,
                         out_dtype, tail_dtype)[:4]


def _fm_audio_ref(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
                  tail_dtype):
    """``fm_audio_ref``'s four results, then the discriminator's output
    d [C, n_if] and the audio FIR's u [C, n_if]."""
    C, plan = _check_fm(pipe, iq, m_if, gate, qprev, ftail, ptail)
    hf, ker = pipe.taps(iq.device, tail_dtype)
    n = plan["n_if"]
    x = torch.zeros((2 * C, n), dtype=torch.float32, device=iq.device)
    w = min(m_if, n)
    x[:, :w] = iq[:, :w].float() * torch.cat([gate, gate])[:, None]
    er, ei = x[:C], x[C:]
    erp = torch.cat([qprev[:C, None], er[:, :-1]], dim=1)
    eip = torch.cat([qprev[C:, None], ei[:, :-1]], dim=1)
    re = er * erp + ei * eip
    im = ei * erp - er * eip
    re = torch.where(re.abs() < _TINY, torch.zeros_like(re), re)
    im = torch.where(im.abs() < _TINY, torch.zeros_like(im), im)
    d = atan2_poly(im, re) * _f32(pipe.inv_dev)
    extf = torch.cat([ftail, d], dim=1)
    u = poly_rows(extf, hf[None, :], 1, 1)                     # [C, n]
    extp = torch.cat([ptail, u], dim=1)
    audio = poly_rows(extp, ker, pipe.I, pipe.D)[:, :plan["n_aud"]]
    nq = round_to(x[:, m_if - 1], tail_dtype)
    nf = round_to(extf[:, m_if:m_if + pipe.histF], tail_dtype)
    np_ = round_to(extp[:, m_if:m_if + pipe.histP], tail_dtype)
    return audio.to(out_dtype).contiguous(), nq, nf, np_, d, u


# ---- K7's plan (csrc/fm_audio.cu) -------------------------------------------

def fm_plan(pipe, m_if: int, C: int) -> dict:
    """How K7 runs C channels of m_if IF samples in two launches, the
    audio FIR (u through an HBM scratch) then the polyphase: ``n_u``, the
    u samples that can be nonzero (d is 0 from m_if on); the FIR launch's
    grid ``fir`` (P = 5 outputs a lane, 8 warps, chunks of 160 outputs
    halved from 4 a block until the launch has 4 blocks an SM, as
    ``wfm_kernel.demod_plan`` sizes K2's discriminator launch) and the
    polyphase's ``poly``: all I phase rows a block on one chunk of 96
    groups (P = 3), so that a block stages its input span once for all
    rows, where that gives SMS blocks, else ``fir_plan``'s
    (``scripts/demod_sweep.py --plans`` ranks both grids)."""
    plan = pipe.plan(m_if)
    I, D, kw, Kf = pipe.I, pipe.D, pipe.kernel.shape[1], len(pipe.hf)
    n_u = min(plan["n_if"], m_if + Kf - 1)
    n_aud = plan["n_aud"]
    P = 5
    n_c = -(-n_u // (32 * P))
    Cc = min(4, n_c)
    while Cc > 1 and C * -(-n_c // Cc) < 4 * SMS:
        Cc = (Cc + 1) // 2
    grid = (-(-n_c // Cc), 1, C)
    fir = {"P": P, "C": Cc, "warps": 8, "grid": grid,
           "blocks": math.prod(grid),
           "smem": tile_smem(1, Kf, n_u, P, 1, Cc, 1)}
    n_m = n_aud // I
    if C * -(-n_m // 96) >= SMS:
        grid = (-(-n_m // 96), 1, C)
        poly = {"P": 3, "G": I, "C": 1, "warps": 8, "grid": grid,
                "blocks": math.prod(grid),
                "smem": tile_smem(D, kw, n_m, 3, I, 1, 1)}
    else:
        poly = fir_plan(I, D, kw, n_aud, C, 1)
    return {"n_u": n_u, "m_aud": plan["m_aud"], "n_aud": n_aud,
            "n_if": plan["n_if"], "fir": fir, "poly": poly, "launches": 2}


@_build.counted_launches
def fm_audio_kernel(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
                    tail_dtype):
    """K7 on the card (csrc/fm_audio.cu, ``fm_plan``'s two launches, each
    counted in ``launches``); same contract as ``fm_audio_ref``."""
    return _fm_audio_launches(pipe, iq, m_if, gate, qprev, ftail, ptail,
                              out_dtype, tail_dtype)[:4]


def _fm_audio_launches(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
                       tail_dtype, probe: bool = False,
                       plan: dict | None = None):
    """K7's launches on ``plan`` (``fm_plan``'s by default):
    ``fm_audio_kernel``'s four results, then [the discriminator's output
    d (with ``probe``, else None), u], each [C, n_u]."""
    dev = iq.device
    f32 = torch.float32
    C, _ = _check_fm(pipe, iq, m_if, gate, qprev, ftail, ptail)
    if out_dtype not in _STORAGE or tail_dtype not in _STORAGE:
        raise ValueError(f"dtypes {out_dtype}, {tail_dtype}")
    p = plan or fm_plan(pipe, m_if, C)
    hf, ker = pipe.taps(dev, tail_dtype)
    n_u, n_aud = p["n_u"], p["n_aud"]
    audio = torch.empty((C, n_aud), dtype=out_dtype, device=dev)
    nq = torch.empty((2 * C,), dtype=f32, device=dev)
    nf = torch.empty((C, pipe.histF), dtype=f32, device=dev)
    np_ = torch.empty((C, pipe.histP), dtype=f32, device=dev)
    d = torch.empty((C, n_u), dtype=f32, device=dev) if probe else None
    u = torch.empty((C, n_u), dtype=f32, device=dev)
    t_bf16 = int(tail_dtype == torch.bfloat16)
    f, q = p["fir"], p["poly"]
    _build.launch(
        "sdr_fm_audio_fir", dev,
        _build.check(iq, "IF buffer", _STORAGE, device=dev),
        int(iq.dtype == torch.bfloat16), iq.shape[1], m_if,
        _build.check(gate, "gate", f32, (C,), dev),
        _build.check(qprev, "quad state", f32, (2 * C,), dev),
        _build.check(ftail, "audio FIR tail", f32, (C, pipe.histF), dev),
        _build.check(hf, "audio FIR taps", f32, device=dev), hf.shape[0],
        pipe.inv_dev, u.data_ptr(), n_u, nq.data_ptr(), nf.data_ptr(),
        t_bf16, None if d is None else d.data_ptr(), C, f["P"], f["C"],
        f["warps"])
    _build.launch(
        "sdr_fm_audio_poly", dev,
        _build.check(ptail, "polyphase tail", f32, (C, pipe.histP), dev),
        pipe.histP, u.data_ptr(), n_u,
        _build.check(ker, "polyphase kernel", f32, device=dev), pipe.I,
        pipe.D, ker.shape[1], audio.data_ptr(),
        int(out_dtype == torch.bfloat16), n_aud, m_if, np_.data_ptr(),
        t_bf16, C, q["P"], q["G"], q["C"], q["warps"])
    return audio, nq, nf, np_, [d, u]


def fm_audio(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
             tail_dtype):
    """K7 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fm_audio_kernel if iq.is_cuda else fm_audio_ref
    return fn(pipe, iq, m_if, gate, qprev, ftail, ptail, out_dtype,
              tail_dtype)
