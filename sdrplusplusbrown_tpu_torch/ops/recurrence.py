"""First-order recurrences (counterpart of
sdrplusplusbrown_tpu/ops/recurrence.py).

  * ``linear_recurrence`` — y[n] = a[n]·y[n−1] + b[n] along the last axis:
    on the card kernel K15 (csrc/recurrence.cu, one launch: a cluster of
    up to 16 blocks a row, sized by the kernel's launcher from the row's
    length, each block's run staged in shared memory; a warp a segment, batches of 32 lanes × 4 samples
    scanned by shuffles, the segments' and the blocks' maps composed,
    each segment walked from its start); on the
    host its plain version ``linear_recurrence_ref``, in ⌈log2 T⌉
    doubling steps of torch ops whose pairing is the JAX package's
    ``jax.lax.associative_scan`` recursion step for step, so every
    float32 rounding agrees with it.  Its "dc" and "nb" forms take the
    DC blocker's and the noise blanker's elementwise ops (``dc_route``,
    ``nb_route``, the plain route) into the same launch;
  * ``DCBlocker`` — out[n] = x[n] − o[n−1], o[n] = (1−r)·o[n−1] + r·x[n]
    (reference correction/dc_blocker.h): the "dc" form;
  * ``NoiseBlanker`` — the IF chain's amplitude-ratio limiter against a
    running-average envelope (reference noise_reduction/noise_blanker.h):
    the "nb" form;
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


FORMS = ("scan", "dc", "nb")


def _scan_ref(a, b: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    a = a.expand(b.shape) if torch.is_tensor(a) else torch.full_like(b, a)
    A, B = _scan([a, b])
    return A * y0.unsqueeze(-1) + B


def dc_route(rec, pole: float, x: torch.Tensor, y0: torch.Tensor,
             gain: float):
    """The DC blocker as torch ops around the recurrence ``rec``: o =
    rec(pole, gain·x, y0), out[n] = x[n] − o[n−1] (o[−1] = y0) → (out,
    o[..., −1])."""
    offs = rec(pole, x * gain, y0)
    prev = torch.cat([y0.unsqueeze(-1), offs[..., :-1]], dim=-1)
    return x - prev, offs[..., -1]


def nb_route(rec, pole: float, x: torch.Tensor, y0: torch.Tensor,
             gain: float, level):
    """The noise blanker as torch ops around the recurrence ``rec``: the
    envelope amp = rec(a, b, y0) of m = |x| (a = pole, b = gain·m where m
    ≠ 0, else held: a = 1, b = 0), then x·(1/e where e = m/amp > level,
    else 1) → (out, amp[..., −1])."""
    amp_in = x.abs().float()
    nz = amp_in != 0.0
    one = torch.ones_like(amp_in)
    a = torch.where(nz, pole, one)
    b = torch.where(nz, amp_in * gain, torch.zeros_like(amp_in))
    amp = rec(a, b, y0)
    excess = torch.where(nz, amp_in / amp, one)
    g = torch.where(excess > level, 1.0 / excess, one)
    return x * g, amp[..., -1]


def linear_recurrence_ref(a, b: torch.Tensor, y0: torch.Tensor,
                          form: str = "scan", gain: float = 0.0,
                          level=0.0):
    """Plain K15.  ``form`` "scan": y[n] = a[n]·y[n−1] + b[n] along the
    last axis, y[−1] = y0, ``a`` a scalar or a tensor like ``b``; returns
    the whole y.  "dc" and "nb": the DC blocker and the noise blanker on
    x = ``b`` with the scalar pole ``a`` (``dc_route``, ``nb_route``);
    return (out, new state)."""
    if form == "dc":
        return dc_route(_scan_ref, a, b, y0, gain)
    if form == "nb":
        return nb_route(_scan_ref, a, b, y0, gain, level)
    return _scan_ref(a, b, y0)


@_build.counted
def linear_recurrence_kernel(a, b: torch.Tensor, y0: torch.Tensor,
                             form: str = "scan", gain: float = 0.0,
                             level=0.0):
    """K15 on the card (csrc/recurrence.cu), one launch; same contract as
    ``linear_recurrence_ref``, with ``b`` float32 or complex64, a tensor
    ``a`` float32 of b's shape ("scan" only), ``level`` a float or a
    float32 CUDA scalar ("nb").  The port's blocks pass a scalar pole.  A
    pole a sample is the unfused noise blanker (``nb_route`` around this
    kernel), which the "nb" form is held to bit for bit on the card
    (chip_smoke.py, tests/test_torch_cuda.py), and the JAX package's
    ``linear_recurrence`` takes one too."""
    dev = b.device
    if form not in FORMS:
        raise ValueError(f"K15: form {form!r}, expected one of {FORMS}")
    if b.dtype not in (torch.float32, torch.complex64) or b.dim() < 1:
        raise ValueError(f"K15: b {tuple(b.shape)} {b.dtype}, expected "
                         f"float32 or complex64 [..., T]")
    T = b.shape[-1]
    R = b.numel() // T if T else 0
    b = b.contiguous()
    vdt = torch.float32 if form == "nb" else b.dtype
    y0 = y0.to(vdt).expand(b.shape[:-1]).contiguous()
    a_ptr, pole = None, 0.0
    if torch.is_tensor(a):
        if form != "scan":
            raise ValueError(f"K15 {form}: the pole must be a scalar")
        a = a.expand(b.shape).contiguous()  # held until the launch
        a_ptr = _build.check(a, "K15 a", torch.float32, tuple(b.shape), dev)
    else:
        pole = float(a)
    level_ptr, level_scalar = None, 0.0
    if torch.is_tensor(level):
        level_ptr = _build.check(level, "K15 level", torch.float32, (), dev)
    else:
        level_scalar = float(level)
    y = torch.empty_like(b)
    state = None if form == "scan" else torch.empty(
        b.shape[:-1], dtype=vdt, device=dev)
    _build.launch("sdr_linear_recurrence", dev, a_ptr, pole, float(gain),
                  level_ptr, level_scalar,
                  _build.check(b, "K15 b", b.dtype, device=dev),
                  _build.check(y0, "K15 y0", vdt, device=dev), R, T,
                  FORMS.index(form), int(b.is_complex()), y.data_ptr(),
                  None if state is None else state.data_ptr())
    return y if state is None else (y, state)


def linear_recurrence(a, b: torch.Tensor, y0: torch.Tensor,
                      form: str = "scan", gain: float = 0.0, level=0.0):
    """K15 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not b.is_cuda:
        return linear_recurrence_ref(a, b, y0, form, gain, level)
    return linear_recurrence_kernel(a, b, y0, form, gain, level)


class DCBlocker(Block):
    """Running-mean DC removal at ``rate``: the AM demod's 100/IF on its
    envelope (float32), and the IQ front end's 50/SR on the complex64
    baseband; K15's "dc" form, one launch."""

    def __init__(self, rate: float):
        self.rate = float(rate)

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return torch.zeros(batch_shape, dtype=dtype)

    def apply(self, params, state, x):
        # the JAX package's float32 r and 1 − r, as Python scalars (a
        # tensor made on the card would cost a host-to-device copy)
        r = np.float32(self.rate)
        return linear_recurrence(float(np.float32(1.0) - r), x,
                                 state.to(x.device), "dc", float(r))


class NoiseBlanker(Block):
    """Amplitude-ratio limiter against a running average envelope:
    amp[n] = (1−rate)·amp[n−1] + rate·|x[n]| (held over zero samples),
    gain 1/excess where excess = |x|/amp > level, else 1 (reference
    noise_blanker.h:38-58; the radio's rate 500/24000, level 10,
    radio_module.h:92); K15's "nb" form, one launch."""

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
        r = np.float32(self.rate)
        return linear_recurrence(float(np.float32(1.0) - r), x,
                                 state.to(x.device), "nb", float(r), level)


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
