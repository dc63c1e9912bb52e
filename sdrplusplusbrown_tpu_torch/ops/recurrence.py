"""First-order recurrences (counterpart of
sdrplusplusbrown_tpu/ops/recurrence.py).

  * ``linear_recurrence`` — y[n] = a[n]·y[n−1] + b[n] along the last axis:
    on the card kernel K15 (csrc/recurrence.cu, one launch: a block a
    row, a warp a segment, batches of 32 lanes × 4 samples scanned by
    shuffles, the segments' maps scanned, each segment walked from its
    start); on the host its plain version ``linear_recurrence_ref``, in
    ⌈log2 T⌉ doubling steps of torch ops whose pairing is the JAX
    package's ``jax.lax.associative_scan`` recursion step for step, so
    every float32 rounding agrees with it;
  * ``DCBlocker`` — out[n] = x[n] − o[n−1], o[n] = (1−r)·o[n−1] + r·x[n]
    (reference correction/dc_blocker.h), on that recurrence;
  * ``NoiseBlanker`` — the IF chain's amplitude-ratio limiter against a
    running-average envelope (reference noise_reduction/noise_blanker.h),
    on that recurrence;
  * ``Deemphasis`` — the 1-pole de-emphasis y[n] = α·x[n] + (1−α)·y[n−1]
    (reference filter/deephasis.h).  ``Radio`` folds its
    truncated-exponential FIR form into the WFM audio polyphase resampler
    (ops/resampler.py:fold_output_fir); standalone (a mono demod's AF
    chain, or a WFM audio rate the resampler cannot fold into), ``apply``
    runs that FIR on kernel K8 with the carried y[−1] as the head term
    r^(n+1)·y[−1], or, for a pole slower than the 512-tap horizon, the
    recurrence on ``linear_recurrence``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block, device_const
from .fir import RealFIR


def _combine(left, right):
    (a1, b1), (a2, b2) = left, right
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """e0, o0, e1, o1, ... along the last axis (len(even) − len(odd) is
    0 or 1)."""
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _scan(elems):
    """Inclusive scan of (a, b) pairs under ``_combine``: the odd/even
    recursion of ``jax.lax.associative_scan``."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _scan(_combine([e[..., 0:-1:2] for e in elems],
                         [e[..., 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[..., :-1] for e in odd],
                        [e[..., 2::2] for e in elems])
    else:
        even = _combine(odd, [e[..., 2::2] for e in elems])
    even = [torch.cat([e[..., :1], r], dim=-1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def linear_recurrence_ref(a, b: torch.Tensor,
                          y0: torch.Tensor) -> torch.Tensor:
    """Plain K15: y[n] = a[n]·y[n−1] + b[n] along the last axis, y[−1] =
    y0; ``a`` a scalar or a tensor like ``b``.  Returns the whole y."""
    a = a.expand(b.shape) if torch.is_tensor(a) else torch.full_like(b, a)
    A, B = _scan([a, b])
    return A * y0.unsqueeze(-1) + B


@_build.counted
def linear_recurrence_kernel(a, b: torch.Tensor,
                             y0: torch.Tensor) -> torch.Tensor:
    """K15 on the card (csrc/recurrence.cu), one launch; same contract as
    ``linear_recurrence_ref``, with ``b`` float32 or complex64 and a
    tensor ``a`` float32 of b's shape."""
    dev = b.device
    if b.dtype not in (torch.float32, torch.complex64) or b.dim() < 1:
        raise ValueError(f"K15: b {tuple(b.shape)} {b.dtype}, expected "
                         f"float32 or complex64 [..., T]")
    T = b.shape[-1]
    R = b.numel() // T if T else 0
    b = b.contiguous()
    y0 = y0.to(b.dtype).expand(b.shape[:-1]).contiguous()
    if torch.is_tensor(a):
        a = a.expand(b.shape).contiguous()  # held until the launch
        a_ptr = _build.check(a, "K15 a", torch.float32, tuple(b.shape), dev)
        a_scalar = 0.0
    else:
        a_ptr, a_scalar = None, float(a)
    y = torch.empty_like(b)
    _build.launch("sdr_linear_recurrence", dev, a_ptr, a_scalar,
                  _build.check(b, "K15 b", b.dtype, device=dev),
                  _build.check(y0, "K15 y0", b.dtype, device=dev), R, T,
                  int(b.is_complex()), y.data_ptr())
    return y


def linear_recurrence(a, b: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """K15 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not b.is_cuda:
        return linear_recurrence_ref(a, b, y0)
    return linear_recurrence_kernel(a, b, y0)


class DCBlocker(Block):
    """Running-mean DC removal at ``rate``: the AM demod's 100/IF on its
    IF, and the IQ front end's 50/SR on the complex64 baseband (state
    complex64 in both)."""

    def __init__(self, rate: float):
        self.rate = float(rate)

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return torch.zeros(batch_shape, dtype=dtype)

    def apply(self, params, state, x):
        # the JAX package's float32 r and 1 − r, as Python scalars (a
        # tensor made on the card would cost a host-to-device copy)
        r = np.float32(self.rate)
        state = state.to(x.device)
        offs = linear_recurrence(float(np.float32(1.0) - r), x * float(r),
                                 state)
        prev = torch.cat([state.unsqueeze(-1), offs[..., :-1]], dim=-1)
        return x - prev, offs[..., -1]


class NoiseBlanker(Block):
    """Amplitude-ratio limiter against a running average envelope:
    amp[n] = (1−rate)·amp[n−1] + rate·|x[n]| (held over zero samples),
    gain 1/excess where excess = |x|/amp > level, else 1 (reference
    noise_blanker.h:38-58; the radio's rate 500/24000, level 10,
    radio_module.h:92)."""

    def __init__(self, rate: float = 500.0 / 24000.0, level: float = 10.0):
        self.rate = float(rate)
        self.default_level = float(level)

    def init_state(self, batch_shape=()):
        return torch.ones(batch_shape, dtype=torch.float32)

    def init_params(self):
        return {"level": torch.tensor(self.default_level,
                                      dtype=torch.float32)}

    def apply(self, params, state, x):
        level = params["level"].to(x.device) if params \
            else float(np.float32(self.default_level))
        amp_in = x.abs().float()
        nz = amp_in != 0.0
        r = np.float32(self.rate)
        one = torch.ones_like(amp_in)
        a = torch.where(nz, float(np.float32(1.0) - r), one)
        b = torch.where(nz, amp_in * float(r), torch.zeros_like(amp_in))
        amp = linear_recurrence(a, b, state.to(x.device))
        excess = torch.where(nz, amp_in / amp, one)
        gain = torch.where(excess > level, 1.0 / excess, one)
        return x * gain, amp[..., -1]


class Deemphasis(Block):
    _FIR_KMAX = 512

    def __init__(self, tau: float, samplerate: float):
        dt = 1.0 / float(samplerate)
        self.alpha = float(dt / (tau + dt))
        self.tau = tau
        self.samplerate = samplerate
        r = 1.0 - self.alpha
        # horizon: r^K < 2^-27 (an lsb-level tail on fp32 audio)
        K = int(np.ceil(-27.0 * np.log(2.0) / np.log(r))) if r > 0.0 else 1
        self.fir_k = K if K <= self._FIR_KMAX else 0
        if self.fir_k:
            # correlate() convention: out[i] = Σ_k ext[i+k]·taps[k]
            self.fir = RealFIR(self.impulse()[::-1].astype(np.float32))

    def impulse(self) -> np.ndarray:
        """Causal impulse response h[j] = α·(1−α)^j, length fir_k."""
        if not self.fir_k:
            raise ValueError("pole too slow for the FIR horizon")
        r = 1.0 - self.alpha
        return (self.alpha
                * np.power(np.float64(r), np.arange(self.fir_k)))

    def init_state(self, batch_shape=()):
        return torch.zeros(batch_shape, dtype=torch.float32)

    def _head_pow(self, T: int) -> np.ndarray:
        r = 1.0 - self.alpha
        pw = np.zeros(T, np.float32)
        n = min(self.fir_k, T)
        pw[:n] = np.power(np.float64(r), np.arange(1, n + 1))
        return pw

    def apply(self, params, state, x):
        """x: float32 [..., T] → (y, y[..., −1]).  The FIR form starts
        from zero history and adds the carried output's decay
        r^(n+1)·y[−1] over the first fir_k samples (the JAX package's
        form, op for op)."""
        state = state.to(x.device)
        if not self.fir_k:
            y = linear_recurrence(float(np.float32(1.0 - self.alpha)),
                                  x * float(np.float32(self.alpha)), state)
            return y, y[..., -1]
        T = x.shape[-1]
        zero = x.new_zeros(x.shape[:-1] + (self.fir_k - 1,))
        y, _ = self.fir.apply(None, zero, x)
        head = device_const(self, f"head{T}", lambda: self._head_pow(T),
                            x.device)
        y = y + head * state[..., None]
        return y, y[..., -1]
