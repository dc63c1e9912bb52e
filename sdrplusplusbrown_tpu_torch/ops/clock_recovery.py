"""Mueller–Müller and frequency-derivative symbol timing recovery
(counterpart of sdrplusplusbrown_tpu/ops/clock_recovery.py; reference
dsp/clock_recovery/mm.h and fd.h).

Per output symbol an 8-tap polyphase-interpolated sample is taken at the
loop's fractional position; the M&M timing error (real:
step(y[n−1])·y[n] − y[n−1]·step(y[n]); complex: Re{(p0−p2)·conj(c1) −
(c0−c2)·conj(p1)}) drives a second-order loop whose phase is the
fractional sample position and whose frequency the samples-per-symbol
estimate (clamped to ±omegaRelLimit).  As in the JAX package the loop
runs a fixed ``max_out(T)`` steps and masks the tail: out (symbols,
valid); a step past the block (offset >= T) is not valid and leaves the
state as it was.

The position advances by a floor of the loop's own output, so the loop
is sequential: the JAX package runs a ``lax.scan``; the port runs kernel
K13's M&M form (csrc/loops.cu: two warps staging the row's [tail | x]
into a ring of chunks in shared memory, one warp walking the loop in runs
of up to 32 steps that need no check; ``mm_schedule`` models its plan) on
a CUDA tensor and ``mm_rows_ref``, the same loop vectorised over rows, on
a CPU tensor.
The interpolation sums its taps in ascending order, each product and sum
rounded.  The kernel takes the 8 taps that every caller uses
(``KERNEL_TAPS``) and a bank of a power of two rows (every caller's is
128); another ``interp_tap_count`` or ``interp_phase_count`` raises on a
CUDA tensor and runs the plain version on a CPU tensor.

``FDClockRecovery`` is the same loop on real data with the timing error
taken from the interpolator's slope, err = dfdt·step(y), dfdt from the
bank's rows either side of the symbol's (fd.h:105-134): kernel K13's FD
form (K13f, ``fd_rows_kernel``) on a CUDA tensor, ``fd_rows_ref`` on a
CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block, device_const
from . import taps as taps_mod
from .resampler import build_polyphase_bank

_PC = ("p0", "p1", "p2", "c0", "c1", "c2")
KERNEL_TAPS = 8         # the interpolator's taps in csrc/loops.cu (MM_K)


def _step(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0, 1.0, -1.0)


def _coefs(mm) -> tuple:
    """(α, β, ω·(1 − rel), ω·(1 + rel)) as float32 values."""
    f = np.float32
    return tuple(float(f(v)) for v in (
        mm.mu_gain, mm.omega_gain, mm.omega * (1.0 - mm.rel),
        mm.omega * (1.0 + mm.rel)))


def _check(mm, x, state):
    want = torch.complex64 if mm.complex_data else torch.float32
    if x.dtype != want or x.dim() != 2:
        raise ValueError(f"M&M rows: {tuple(x.shape)} {x.dtype}, expected "
                         f"{want} [rows, T]")
    R = x.shape[0]
    if state["tail"].shape != (R, mm.K - 1) or state["tail"].dtype != want:
        raise ValueError(f"M&M tail: {tuple(state['tail'].shape)}, "
                         f"expected [{R}, {mm.K - 1}] {want}")
    if state["offset"].shape != (R,) or state["offset"].dtype != torch.int32:
        raise ValueError("M&M offset: int32 [rows]")


def _kernel_taps(mm) -> None:
    if mm.K != KERNEL_TAPS:
        raise ValueError(f"K13 on the card takes {KERNEL_TAPS} interpolator "
                         f"taps, not {mm.K}")
    if mm.P < 1 or mm.P & (mm.P - 1):
        raise ValueError(f"K13 on the card takes a bank of a power of two "
                         f"rows, not {mm.P}")


def _interp(win: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Σ_k win[:, k]·taps[:, k] in ascending k, each operation rounded."""
    acc = win[:, 0] * taps[:, 0]
    for k in range(1, win.shape[1]):
        acc = acc + win[:, k] * taps[:, k]
    return acc


def _slope(ph_idx: torch.Tensor, P: int, out, lo, hi) -> torch.Tensor:
    """FD's dfdt: hi − out at row 0, out − lo at row P − 1, else
    (hi − lo)·0.5 (clock_recovery/fd.h:105-134)."""
    return torch.where(ph_idx == 0, hi - out,
                       torch.where(ph_idx == P - 1, out - lo,
                                   (hi - lo) * 0.5))


def mm_rows_ref(mm, x, state):
    """Plain PyTorch K13 (M&M form): x [R, T] (float32, or complex64 for
    ``complex_data``) and a state dict of [R] leaves (tail [R, K − 1]) →
    ((symbols [R, n_out] of x's dtype, valid [R, n_out] bool), state')."""
    _check(mm, x, state)
    R, T = x.shape
    n_out = mm.max_out(T)
    alpha, beta, fmin, fmax = _coefs(mm)
    bank = torch.from_numpy(mm.bank).to(x.device)
    ext = torch.cat([state["tail"], x], dim=-1)
    planes = (ext.real, ext.imag) if mm.complex_data else (ext,)
    idx = torch.arange(mm.K, device=x.device)
    st = {k: v.clone() for k, v in state.items() if k != "tail"}
    outs = [torch.empty(R, n_out, dtype=torch.float32, device=x.device)
            for _ in planes]
    valids = torch.empty(R, n_out, dtype=torch.bool, device=x.device)
    for n in range(n_out):
        off = st["offset"]
        valid = off < T
        ph_idx = torch.clamp((st["phase"] * float(mm.P)).to(torch.int32),
                             0, mm.P - 1)
        start = torch.clamp(off, 0, T - 1)
        gidx = (start[:, None] + idx).long()
        taps = bank[ph_idx.long()]
        out = [_interp(torch.gather(p, 1, gidx), taps) for p in planes]
        for o, v in zip(outs, out):
            o[:, n] = v
        valids[:, n] = valid
        upd = {}
        if mm.complex_data:
            p0 = torch.complex(out[0], out[1])
            c0 = torch.complex(_step(out[0]), _step(out[1]))
            p1, p2 = st["p0"], st["p1"]
            c1, c2 = st["c0"], st["c1"]
            a, c = p0 - p2, c0 - c2
            e1 = a.real * c1.real + a.imag * c1.imag
            e2 = c.real * p1.real + c.imag * p1.imag
            err = e1 - e2
            upd = {"p0": p0, "p1": p1, "p2": p2, "c0": c0, "c1": c1,
                   "c2": c2}
        else:
            last = st["last_out"]
            err = _step(last) * out[0] - last * _step(out[0])
            upd = {"last_out": out[0]}
        err = torch.clamp(err, -1.0, 1.0)
        freq = torch.clamp(st["freq"] + beta * err, fmin, fmax)
        phase = (st["phase"] + freq) + alpha * err
        delta = torch.floor(phase).to(torch.int32)
        upd.update(freq=freq, phase=phase - delta.float(), offset=off + delta)
        for k, v in upd.items():
            st[k] = torch.where(valid, v, st[k])
    st["offset"] = st["offset"] - T
    st["tail"] = ext[:, ext.shape[-1] - (mm.K - 1):]
    sym = outs[0] if not mm.complex_data else torch.complex(*outs)
    return (sym, valids), st


def _check_fd(fd, x, state):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"FD rows: {tuple(x.shape)} {x.dtype}, expected "
                         f"float32 [rows, T]")
    R = x.shape[0]
    if state["tail"].shape != (R, fd.K - 1) or \
            state["tail"].dtype != torch.float32:
        raise ValueError(f"FD tail: {tuple(state['tail'].shape)}, expected "
                         f"[{R}, {fd.K - 1}] float32")
    if state["offset"].shape != (R,) or state["offset"].dtype != torch.int32:
        raise ValueError("FD offset: int32 [rows]")


def fd_rows_ref(fd, x, state):
    """Plain PyTorch K13f (the FD form): x float32 [R, T] and a state dict
    (tail [R, K − 1], phase, freq [R] float32, offset [R] int32) →
    ((symbols [R, n_out], valid [R, n_out] bool), state')."""
    _check_fd(fd, x, state)
    R, T = x.shape
    n_out = fd.max_out(T)
    alpha, beta, fmin, fmax = _coefs(fd)
    bank = torch.from_numpy(fd.bank).to(x.device)
    ext = torch.cat([state["tail"], x], dim=-1)
    idx = torch.arange(fd.K, device=x.device)
    st = {k: v.clone() for k, v in state.items() if k != "tail"}
    outs = torch.empty(R, n_out, dtype=torch.float32, device=x.device)
    valids = torch.empty(R, n_out, dtype=torch.bool, device=x.device)
    for n in range(n_out):
        off = st["offset"]
        valid = off < T
        ph_idx = torch.clamp((st["phase"] * float(fd.P)).to(torch.int32),
                             0, fd.P - 1)
        win = torch.gather(ext, 1, (torch.clamp(off, 0, T - 1)[:, None]
                                    + idx).long())
        pi = ph_idx.long()
        out = _interp(win, bank[pi])
        lo = _interp(win, bank[torch.clamp(pi - 1, min=0)])
        hi = _interp(win, bank[torch.clamp(pi + 1, max=fd.P - 1)])
        outs[:, n] = out
        valids[:, n] = valid
        err = torch.clamp(_slope(ph_idx, fd.P, out, lo, hi) * _step(out),
                          -1.0, 1.0)
        freq = torch.clamp(st["freq"] + beta * err, fmin, fmax)
        phase = (st["phase"] + freq) + alpha * err
        delta = torch.floor(phase).to(torch.int32)
        upd = dict(freq=freq, phase=phase - delta.float(), offset=off + delta)
        for k, v in upd.items():
            st[k] = torch.where(valid, v, st[k])
    st["offset"] = st["offset"] - T
    st["tail"] = ext[:, ext.shape[-1] - (fd.K - 1):]
    return (outs, valids), st


#: the ring and the runs of K13m (csrc/loops.cu: MM_CH, MM_NCH, MM_RUN)
RING_CHUNK = 1024
RING_CHUNKS = 4
RUN = 32


def run_bound(mm) -> int:
    """The runs' bound that the wrappers pass to K13m and K13f: the most a
    step advances the window once the phase is in [0, 1).  A step moves it
    by floor((ph + fr) + α·err), at most floor((1 + hi) + |α|) and at least
    floor(lo − |α|) for fr in the frequency clamp's range [lo, hi] and
    |err| ≤ 1 (float32 sums round monotonically, so the bounds hold as
    rounded).  At least 1; 0 where a step may go back (lo < |α|) and the
    kernel takes every step with its checks."""
    f = np.float32
    alpha, _, fmin, fmax = (f(v) for v in _coefs(mm))
    lo, hi = min(fmin, fmax), max(fmin, fmax)
    most = (f(1.0) + hi) + abs(alpha)
    if not (lo >= abs(alpha) and most < f(1e6)):
        return 0
    return max(int(np.floor(most)), 1)


def mm_schedule(T: int, offset: int, n_out: int, dmax: int, advance):
    """A model of K13m's plan on one row of T samples (csrc/loops.cu:
    mm_kernel) from the carried ``offset``, the loop's steps advancing the
    window by ``advance(n)`` (the floor of step n's phase), ``dmax`` as
    ``run_bound``.  Returns a dict: ``chunks`` [(ext start, length, slot)]
    the staging warps write, ``events`` the chain's ("acquire" | "release",
    chunk) and ("read", window start, "ring" | "global", n) in order,
    ``symbols`` [(first, count, "run" | "step" | "fill")] and ``valid``,
    the number of valid steps.  The model holds the plan's rules as it
    goes (a run's windows staged, not passed and in the block; a chunk
    waited for only when the staging warps can have written it)."""
    H, CH, NCH = KERNEL_TAPS - 1, RING_CHUNK, RING_CHUNKS
    n_ext = H + T
    e0 = min(max(offset, 0), T - 1)
    nch = -(-(n_ext - e0) // CH)
    chunks = [(e0 + c * CH, min(CH, n_ext - e0 - c * CH), c % NCH)
              for c in range(nch)]
    events, symbols = [], []
    got = {"avail": 0, "released": 0}

    def acquire_to(c):
        for a in range(got["avail"], min(c, nch)):
            # the staging warps fill chunk a once a - NCH is passed
            assert a < got["released"] + NCH, ("waits on an unstaged chunk",
                                               a, got)
            events.append(("acquire", a))
            got["avail"] = a + 1

    def release_to(c):
        for a in range(got["released"], min(c, nch)):
            acquire_to(a + 1)
            events.append(("release", a))
            got["released"] = a + 1

    o, n, nv = offset, 0, n_out
    while n < n_out:
        K = 0
        if dmax > 0 and n > 0 and e0 <= o < T:
            ob = o - e0
            release_to(ob // CH)
            acquire_to((ob + KERNEL_TAPS - 1) // CH + 2)
            lim = min(T - 1 - o, e0 + got["avail"] * CH - KERNEL_TAPS - o)
            K = min(n_out - n,
                    RUN if lim >= (RUN - 1) * dmax else lim // dmax + 1)
        if K > 0:
            for j in range(K):
                assert e0 + got["released"] * CH <= o and o < T, (o, got)
                assert o + KERNEL_TAPS <= e0 + got["avail"] * CH, (o, got)
                events.append(("read", o, "ring", n + j))
                d = advance(n + j)
                assert 0 <= d <= dmax, d
                o += d
            symbols.append((n, K, "run"))
            n += K
            continue
        start = min(max(o, 0), T - 1)
        sb = start - e0
        cl = (sb + KERNEL_TAPS - 1) // CH
        if sb >= got["released"] * CH and cl < min(got["released"] + NCH,
                                                   nch):
            acquire_to(cl + 1)
            events.append(("read", start, "ring", n))
        else:
            events.append(("read", start, "global", n))
        symbols.append((n, 1, "step"))
        if o >= T:
            nv = n
            if n + 1 < n_out:
                symbols.append((n + 1, n_out - n - 1, "fill"))
            break
        o += advance(n)
        n += 1
    release_to(nch)
    return {"chunks": chunks, "events": events, "symbols": symbols,
            "valid": nv, "e0": e0}


def _leaves(mm) -> tuple:
    """The float state leaves in the kernel's order (csrc/loops.cu:MMState):
    phase, freq, then last_out or p0 … c2."""
    return ("phase", "freq") + (_PC if mm.complex_data else ("last_out",))


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


@_build.counted
def mm_rows_kernel(mm, x, state, clk=None):
    """K13's M&M form on the card (csrc/loops.cu); same contract as
    ``mm_rows_ref``.  The state leaves go to the kernel as they are, each
    by its pointer.  ``clk``: see ``_build.chain_clock``."""
    dev = x.device
    _check(mm, x, state)
    _kernel_taps(mm)
    R, T = x.shape
    n_out = mm.max_out(T)
    dt = x.dtype
    tail = _build.check(state["tail"], "M&M tail", dt, (R, mm.K - 1), dev)
    keys = _leaves(mm)
    for k in keys:
        _build.check(state[k], f"M&M {k}",
                     torch.complex64 if k in _PC else torch.float32, (R,), dev)
    sym = torch.empty(R, n_out, dtype=dt, device=dev)
    valid = torch.empty(R, n_out, dtype=torch.bool, device=dev)
    st = {k: torch.empty_like(state[k]) for k in keys}
    st.update(tail=torch.empty_like(state["tail"]),
              offset=torch.empty_like(state["offset"]))
    bank = device_const(mm, "bank", mm.bank, dev)
    _build.launch(
        "sdr_mm_rows", dev, _build.check(x, "M&M input", dt, device=dev), R,
        T, int(mm.complex_data), tail, _ptrs([state[k] for k in keys]),
        _build.check(state["offset"], "M&M offset", torch.int32, (R,), dev),
        bank.data_ptr(), mm.P, mm.K, n_out, run_bound(mm), *_coefs(mm),
        sym.data_ptr(),
        valid.data_ptr(), st["tail"].data_ptr(), _ptrs([st[k] for k in keys]),
        st["offset"].data_ptr(), _build.chain_clock(clk, R, dev))
    return (sym, valid), st


@_build.counted
def fd_rows_kernel(fd, x, state, clk=None):
    """K13f, the FD form of K13's clock recovery, on the card
    (csrc/loops.cu); same contract as ``fd_rows_ref``."""
    dev = x.device
    _check_fd(fd, x, state)
    _kernel_taps(fd)
    R, T = x.shape
    n_out = fd.max_out(T)
    f32 = torch.float32
    args = [_build.check(state[k], f"FD {k}", f32, (R,), dev)
            for k in ("phase", "freq")]
    sym = torch.empty(R, n_out, dtype=f32, device=dev)
    valid = torch.empty(R, n_out, dtype=torch.bool, device=dev)
    st = {k: torch.empty_like(state[k])
          for k in ("tail", "phase", "freq", "offset")}
    bank = device_const(fd, "bank", fd.bank, dev)
    _build.launch(
        "sdr_fd_rows", dev, _build.check(x, "FD input", f32, device=dev), R,
        T, _build.check(state["tail"], "FD tail", f32, (R, fd.K - 1), dev),
        *args,
        _build.check(state["offset"], "FD offset", torch.int32, (R,), dev),
        bank.data_ptr(), fd.P, fd.K, n_out, run_bound(fd), *_coefs(fd),
        sym.data_ptr(),
        valid.data_ptr(), st["tail"].data_ptr(), st["phase"].data_ptr(),
        st["freq"].data_ptr(), st["offset"].data_ptr(),
        _build.chain_clock(clk, R, dev))
    return (sym, valid), st


def fd_rows(fd, x, state):
    """K13f dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fd_rows_kernel if x.is_cuda else fd_rows_ref
    return fn(fd, x, state)


def mm_rows(mm, x, state):
    """K13 (M&M form) dispatch: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = mm_rows_kernel if x.is_cuda else mm_rows_ref
    return fn(mm, x, state)


class MMClockRecovery(Block):
    def __init__(self, omega: float, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01,
                 interp_phase_count: int = 128, interp_tap_count: int = 8,
                 complex_data: bool = True):
        self.omega = float(omega)              # samples per symbol
        self.omega_gain = float(omega_gain)    # beta
        self.mu_gain = float(mu_gain)          # alpha
        self.rel = float(omega_rel_limit)
        self.P = int(interp_phase_count)
        self.K = int(interp_tap_count)
        self.complex_data = complex_data
        # reference generateInterpTaps (mm.h:175-180)
        bw = 0.5 / self.P
        proto = taps_mod.windowed_sinc(self.P * self.K,
                                       2.0 * np.pi * bw, norm=self.P)
        self.bank = build_polyphase_bank(self.P, proto).astype(np.float32)

    def max_out(self, in_len: int) -> int:
        return int(math.ceil(in_len / (self.omega * (1.0 - self.rel)))) + 2

    def init_state(self, batch_shape=()):
        dtype = torch.complex64 if self.complex_data else torch.float32
        st = {
            "tail": torch.zeros(batch_shape + (self.K - 1,), dtype=dtype),
            "phase": torch.zeros(batch_shape, dtype=torch.float32),
            "freq": torch.full(batch_shape, self.omega, dtype=torch.float32),
            "offset": torch.zeros(batch_shape, dtype=torch.int32),
        }
        if self.complex_data:
            for k in _PC:
                st[k] = torch.zeros(batch_shape, dtype=torch.complex64)
        else:
            st["last_out"] = torch.zeros(batch_shape, dtype=torch.float32)
        return st

    def apply(self, params, state, x):
        """x [..., T] → ((symbols [..., max_out(T)], valid), state').  The
        JAX block takes one stream (batch ()); the port also takes rows."""
        return self._rows(mm_rows, state, x)

    def _rows(self, fn, state, x):
        lead, T = x.shape[:-1], x.shape[-1]
        rows = math.prod(lead)
        dev = x.device
        dt = torch.complex64 if self.complex_data else torch.float32
        st = {k: v.to(dev).reshape((rows,) + v.shape[len(lead):])
              .contiguous() for k, v in state.items()}
        (sym, valid), st = fn(
            self, x.to(dt).reshape(rows, T).contiguous(), st)
        n = sym.shape[-1]
        return ((sym.reshape(lead + (n,)), valid.reshape(lead + (n,))),
                {k: v.reshape(lead + v.shape[1:]) for k, v in st.items()})


class FDClockRecovery(MMClockRecovery):
    """Frequency-derivative timing recovery for real symbol streams
    (reference clock_recovery/fd.h): the M&M loop, its bank and limits,
    with err = dfdt·step(y) and no symbol history in the state."""

    def __init__(self, omega: float, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01,
                 interp_phase_count: int = 128, interp_tap_count: int = 8):
        super().__init__(omega, omega_gain, mu_gain, omega_rel_limit,
                         interp_phase_count, interp_tap_count,
                         complex_data=False)

    def init_state(self, batch_shape=()):
        st = super().init_state(batch_shape)
        del st["last_out"]
        return st

    def apply(self, params, state, x):
        """x [..., T] real → ((symbols [..., max_out(T)], valid),
        state')."""
        return self._rows(fd_rows, state, x)
