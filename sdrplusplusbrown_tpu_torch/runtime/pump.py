"""Host-side streaming pump: source blocks → the front end and a radio
bank → sinks (counterpart of sdrplusplusbrown_tpu/runtime/pump.py).

A single host loop feeds granularity-aligned blocks to the front end and
the bank, called directly (no compile step), and hands results to sink
callbacks.  Dispatch-ahead pipelining is free: CUDA launches are
asynchronous, so the host queues block N+1 while the device runs block
N; results are copied to the host, one block late, only where a sink
consumes them.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


class Rechunker:
    """Accumulate arbitrary-size source blocks into fixed ``out_len``
    blocks (host-side; the analog of the reference's stream buffering,
    core/src/dsp/buffer/frame_buffer.h)."""

    def __init__(self, out_len: int, dtype=np.complex64):
        self.out_len = int(out_len)
        self._buf = np.zeros(0, dtype)

    def push(self, blk: np.ndarray) -> List[np.ndarray]:
        self._buf = np.concatenate([self._buf, blk]) if self._buf.size \
            else np.asarray(blk)
        out = []
        while len(self._buf) >= self.out_len:
            out.append(self._buf[:self.out_len])
            self._buf = self._buf[self.out_len:]
        return out


class RealTimeGuard:
    """Real-time pacing guard + elastic degradation policy.

    The reference's IF noise reducer self-disables when processing
    costs ≥95% of the real-time budget two reports in a row
    (misc_modules/noise_reduction_logmmse/src/if_nr.h:117-139).  Every
    block reports (elapsed, budget); the guard keeps a rolling real-time
    factor (elapsed/budget — >1 means falling behind) and a
    seconds-behind estimate, and returns ``True`` exactly once when the
    degradation policy should fire (sustained ≥``threshold`` of budget
    for ``strikes_needed`` consecutive blocks)."""

    def __init__(self, threshold: float = 0.95, strikes_needed: int = 2,
                 window: int = 32):
        self.threshold = float(threshold)
        self.strikes_needed = int(strikes_needed)
        self.window = int(window)
        self.strikes = 0
        self.ratios: List[float] = []
        self.behind_s = 0.0          # accumulated lag vs real time
        self.fired = False

    def report(self, elapsed: float, budget: float) -> bool:
        """Returns True when the degradation policy should fire NOW."""
        r = elapsed / budget if budget > 0 else 0.0
        self.ratios.append(r)
        if len(self.ratios) > self.window:
            self.ratios.pop(0)
        # lag accumulates when over budget and drains when under
        self.behind_s = max(0.0, self.behind_s + elapsed - budget)
        if r >= self.threshold:
            self.strikes += 1
        else:
            self.strikes = 0
        if self.strikes >= self.strikes_needed and not self.fired:
            self.fired = True
            return True
        return False

    @property
    def rt_factor(self) -> float:
        return (sum(self.ratios) / len(self.ratios)) if self.ratios \
            else 0.0

    @property
    def seconds_behind(self) -> float:
        """Accumulated processing lag in SECONDS (feeds /status
        ``secondsBehind``): grows by (elapsed - budget) on over-budget
        blocks, drains on under-budget ones, floored at zero."""
        return self.behind_s

    def reset_policy(self):
        """Re-arm the degradation policy (e.g. after a manual
        re-enable)."""
        self.fired = False
        self.strikes = 0


class StreamPump:
    """Wire a source iterator through IQFrontEnd + RadioBank.

    ``sinks`` maps demod_id → callback(audio_np [C,2,T]); a ``spectrum``
    callback receives each block's dB spectra.  Results are copied to the
    host one block late, so the device runs a block while the host
    queues the next.
    """

    def __init__(self, frontend, bank, block_len: Optional[int] = None):
        self.frontend = frontend
        self.bank = bank
        # the bank sees frontend output: its granularity maps back to the
        # input as the rational bank.in_multiple / frontend.ratio; valid
        # input lengths are multiples of that fraction's numerator (same
        # rule as runtime.block.Chain)
        need = Fraction(bank.in_multiple) / frontend.ratio
        g = math.lcm(frontend.in_multiple, need.numerator)
        self.granularity = g
        self.block_len = ((block_len or g) + g - 1) // g * g

    def _step(self, fstate, bparams, bstate, x):
        (bb, spectra), fstate = self.frontend.apply(None, fstate, x)
        outs, bstate = self.bank.apply(bparams, bstate, bb)
        return fstate, bstate, outs, spectra

    def run(self, blocks: Iterable[np.ndarray],
            sinks: Optional[Dict[int, Callable]] = None,
            spectrum: Optional[Callable] = None,
            max_blocks: Optional[int] = None) -> int:
        sinks = sinks or {}
        fstate = self.frontend.init_state(())
        bstate = self.bank.init_state()
        bparams = self.bank.make_params()
        rc = Rechunker(self.block_len)
        pending = None
        n = 0

        def drain(res):
            _fs, _bs, outs, spectra = res
            for d, cb in sinks.items():
                if d in outs:
                    cb(outs[d].cpu().numpy())
            if spectrum is not None:
                spectrum(spectra.cpu().numpy())

        for blk in blocks:
            for chunk in rc.push(blk):
                res = self._step(fstate, bparams, bstate,
                                 torch.from_numpy(chunk))
                fstate, bstate = res[0], res[1]
                if pending is not None:
                    drain(pending)
                pending = res
                n += 1
                if max_blocks is not None and n >= max_blocks:
                    drain(pending)
                    return n
        if pending is not None:
            drain(pending)
        return n
