"""Shared-wideband mix-down folded into the first decimating FIR — kernel
K11 and its plain version (counterpart of
sdrplusplusbrown_tpu/ops/fused_frontend.py).

    y_c[m] = e^{j(φ_c − ω_c(K−1) + ω_dec,c·m)} · Σ_k g_c[k]·ext[mD + k],
    g_c[k] = h[k]·e^{jω_c k},   ext = concat(tail, x)

The per-channel NCO lives in the channel-modulated taps g_c and a twiddle
at the decimated rate, so the wideband is read once for all C channels.
K1 (ops/mono_frontend.py) runs this stage inside its whole-chain kernel;
the chains K1 cannot take run it in K11 (csrc/fused_mix.cu), with the
later stages on K8 (ops/plane_frontend.py).  The twiddle is the XLA
route's ``rotor`` (ops/xlator.py) for every channel count.  This module
also holds the stage's state layout and the host-float64 runtime params.

Dispatch follows the input: CPU tensors run ``fused_mix_ref``; CUDA
tensors launch ``fused_mix_kernel`` or raise.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from ..runtime.block import Block
from .fir_kernel import SMEM_MAX, SMS
from .xlator import SPAN, _TWO_PI, advance_phase, fmod_floor, rotor

MIX_R = 4                   # consecutive outputs a thread (csrc/fused_mix.cu)
MIX_BLOCKS = (512, 256, 128)   # outputs a block, each dividing 1 024
MIX_CHUNKS = (8, 4, 2, 1)      # channels a chunk


def mix_chunks(C: int, ncm: int) -> list:
    """[(first channel, channels)] of K11's chunks (csrc/fused_mix.cu:
    chunk_of): C // ncm chunks of ncm, then the rest in descending powers
    of two."""
    out = [(i * ncm, ncm) for i in range(C // ncm)]
    c0 = len(out) * ncm
    b = ncm // 2
    while b:
        if (C - c0) & b:
            out.append((c0, b))
            c0 += b
        b //= 2
    return out


def mix_smem(B: int, K: int, D: int, ncm: int) -> int:
    """Shared-memory bytes of one K11 block (csrc/fused_mix.cu:mix_layout):
    D phase planes of the re and the im window, each B + ceil(K/D) +
    MIX_R samples padded by a word every MIX_R, the chunk's taps for both
    passes and four phase parameters a channel."""
    L = B + -(-K // D) + MIX_R
    PS = L + L // MIX_R + 1
    return 4 * (((2 * D * PS + 3) & ~3) + 4 * K * ncm + 4 * ncm)


def fused_plan(T: int, K: int, D: int, C: int) -> dict:
    """K11's grid (csrc/fused_mix.cu): B outputs a block, MIX_R a thread,
    inside one 1 024-output rotor group; grid.y walks the channel chunks
    (at most ``ncm`` channels each, the largest power of two <= min(C, 8)).
    B is the largest of MIX_BLOCKS that still gives 2 blocks an SM (else
    128); a window or tap table that would not fit SMEM_MAX halves ncm,
    then B."""
    M = T // D
    ncm = next(n for n in MIX_CHUNKS if n <= C)
    n_y = len(mix_chunks(C, ncm))
    B = next((b for b in MIX_BLOCKS if -(-M // b) * n_y >= 2 * SMS),
             MIX_BLOCKS[-1])
    while mix_smem(B, K, D, ncm) > SMEM_MAX:
        if ncm > 1:
            ncm //= 2
        elif B > MIX_BLOCKS[-1]:
            B //= 2
        else:
            raise ValueError(f"K11 geometry K={K}, D={D} does not fit "
                             f"{SMEM_MAX} bytes")
    chunks = mix_chunks(C, ncm)
    grid = (-(-M // B), len(chunks))
    return {"M": M, "B": B, "R": MIX_R, "threads": B // MIX_R, "ncm": ncm,
            "chunks": chunks, "grid": grid, "blocks": grid[0] * grid[1],
            "smem": mix_smem(B, K, D, ncm)}


def fused_params(offset_hz, samplerate: float, decim: int) -> dict:
    """Host-float64 runtime params, every span product reduced mod 2π
    before the float32 cast (same keys and values as the JAX package)."""
    omega = -np.asarray(offset_hz, np.float64) * (_TWO_PI / samplerate)
    om_d = omega * decim

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    return {
        "omega": f32(omega),
        "omega_span": f32(np.mod(omega * SPAN, _TWO_PI)),
        "omega_dec": f32(np.mod(om_d + np.pi, _TWO_PI) - np.pi),
        "omega_dec_span": f32(np.mod(om_d * SPAN, _TWO_PI)),
        "omega_dec_sup": f32(np.mod(om_d * 2048, _TWO_PI)),
        "omega_dec_bs": f32(np.mod(om_d * 256, _TWO_PI)),
        # full-rate 1024-sample span for the front end's per-block mix
        # phases, wrapped to (−π, π] in float64
        "omega_mb": f32(np.mod(omega * 1024 + np.pi, _TWO_PI) - np.pi),
    }


def _check(xr, xi, tail_r, tail_i, h, D, omega, phase, omega_dec,
           omega_dec_span):
    """(T, C, M); raises on a bad geometry."""
    T, K, C = xr.shape[-1], h.shape[-1], omega.shape[-1]
    if xr.shape != (T,) or xi.shape != (T,) or T % D:
        raise ValueError(f"wideband planes {tuple(xr.shape)}/"
                         f"{tuple(xi.shape)}, decimation {D}")
    if tail_r.shape != (K - 1,) or tail_i.shape != (K - 1,):
        raise ValueError(f"tail planes {tuple(tail_r.shape)}, expected "
                         f"{K - 1} samples")
    for t in (phase, omega_dec, omega_dec_span):
        if t.shape != (C,):
            raise ValueError(f"per-channel params {tuple(t.shape)}, C {C}")
    return T, C, T // D


def fused_mix_ref(xr, xi, tail_r, tail_i, h, D: int, omega, phase,
                  omega_dec, omega_dec_span):
    """Plain PyTorch K11: y [2C, T/D] float32 (re rows, then im rows),
    twiddled."""
    T, C, M = _check(xr, xi, tail_r, tail_i, h, D, omega, phase, omega_dec,
                     omega_dec_span)
    K = h.shape[-1]
    k = torch.arange(K, dtype=torch.float32, device=xr.device)
    ang = omega[:, None] * k
    gr, gi = h * torch.cos(ang), h * torch.sin(ang)
    ext = torch.stack([torch.cat([tail_r, xr]), torch.cat([tail_i, xi])])
    kern = torch.cat([torch.stack([gr, -gi], dim=1),
                      torch.stack([gi, gr], dim=1)])            # [2C, 2, K]
    pre = F.conv1d(ext[None], kern, stride=D)[0, :, :M]
    phase0 = fmod_floor(phase - omega * float(K - 1) + np.pi,
                        _TWO_PI) - np.pi
    y = torch.complex(pre[:C], pre[C:]) * rotor(phase0, omega_dec,
                                                omega_dec_span, M)
    return torch.cat([y.real, y.imag]).contiguous()


@_build.counted
def fused_mix_kernel(xr, xi, tail_r, tail_i, h, D: int, omega, phase,
                     omega_dec, omega_dec_span):
    """K11 on the card (csrc/fused_mix.cu, ``fused_plan``'s grid, one
    launch); same contract as ``fused_mix_ref``."""
    return _launch_mix(xr, xi, tail_r, tail_i, h, D, omega, phase,
                       omega_dec, omega_dec_span)


def _launch_mix(xr, xi, tail_r, tail_i, h, D: int, omega, phase, omega_dec,
                omega_dec_span, plan: dict | None = None):
    """One launch of csrc/fused_mix.cu on ``plan`` (default
    ``fused_plan``'s)."""
    dev = xr.device
    f32 = torch.float32
    T, C, M = _check(xr, xi, tail_r, tail_i, h, D, omega, phase, omega_dec,
                     omega_dec_span)
    K = h.shape[-1]
    plan = plan or fused_plan(T, K, D, C)
    y = torch.empty((2 * C, M), dtype=f32, device=dev)
    _build.launch(
        "sdr_fused_mix", dev, _build.check(xr, "xr", f32, device=dev),
        _build.check(xi, "xi", f32, device=dev), T,
        _build.check(tail_r, "tail re", f32, device=dev),
        _build.check(tail_i, "tail im", f32, device=dev),
        _build.check(h, "taps", f32, (K,), dev), K, D,
        _build.check(omega, "omega", f32, (C,), dev),
        _build.check(phase, "phase", f32, (C,), dev),
        _build.check(omega_dec, "omega_dec", f32, (C,), dev),
        _build.check(omega_dec_span, "omega_dec_span", f32, (C,), dev),
        C, y.data_ptr(), M, plan["B"], plan["ncm"])
    return y


def fused_mix(xr, xi, tail_r, tail_i, h, D: int, omega, phase, omega_dec,
              omega_dec_span):
    """K11 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fused_mix_kernel if xr.is_cuda else fused_mix_ref
    return fn(xr, xi, tail_r, tail_i, h, D, omega, phase, omega_dec,
              omega_dec_span)


class SharedXlateDecimFIR(Block):
    """Shared wideband planes → [2C, T/decim] re/im rows, per-channel ω.
    The overlap tail is the RAW wideband tail, shared by every channel;
    the NCO phase is the only per-channel state."""

    def __init__(self, taps: np.ndarray, samplerate: float, decim: int):
        self.taps = np.asarray(taps, np.float64)
        self.K = len(self.taps)
        self.samplerate = float(samplerate)
        self.decim = int(decim)
        self.ratio = Fraction(1, self.decim)
        self.in_multiple = self.decim
        self._h = {}

    def init_state(self, batch_shape=()):
        (C,) = batch_shape
        return {"tail": torch.zeros((self.K - 1,), dtype=torch.complex64),
                "phase": torch.zeros((C,), dtype=torch.float32)}

    def h(self, device) -> torch.Tensor:
        """The taps as float32 on ``device`` (made once)."""
        key = str(device)
        if key not in self._h:
            self._h[key] = torch.tensor(self.taps.astype(np.float32),
                                        device=device)
        return self._h[key]

    def apply(self, params, state, x):
        """x: (xr, xi) float32 [T] planes of the shared wideband → (y
        [2C, T/decim] float32, re rows then im rows, twiddled; new state).
        One K11 launch on the card."""
        xr, xi = (t.float().contiguous() for t in x)
        T = xr.shape[-1]
        tail, phase = state["tail"], state["phase"]
        y = fused_mix(xr, xi, tail.real.contiguous(),
                      tail.imag.contiguous(), self.h(xr.device), self.decim,
                      params["omega"], phase, params["omega_dec"],
                      params["omega_dec_span"])
        K1 = self.K - 1
        new_tail = (torch.complex(xr[T - K1:], xi[T - K1:]) if T >= K1
                    else torch.cat([tail, torch.complex(xr, xi)])[T:])
        new_phase = advance_phase(phase, params["omega"],
                                  params["omega_span"], T)
        C = phase.shape[0]
        return y, {"tail": new_tail,
                   "phase": torch.broadcast_to(new_phase, (C,)).clone()}
