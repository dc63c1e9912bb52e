"""RxVFO — translate → rational resample → bandwidth FIR (counterpart of
sdrplusplusbrown_tpu/models/rx_vfo.py; reference channel/rx_vfo.h:89-121).

``RxVFO`` is the plain per-channel block.  ``SharedRxVFOBank`` serves C
VFOs of one shared wideband through the front-end kernel K1
(ops/mono_frontend.py), with the mix-down folded into the first
decimating FIR so the wideband is read once for all channels.
"""

from __future__ import annotations

import numpy as np

from ..runtime.block import Block
from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.xlator import FrequencyXlator, nco_params
from ..ops.resampler import RationalResampler


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset_hz: float = 0.0):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset_hz = float(offset_hz)
        self.xlator = FrequencyXlator(-offset_hz, in_samplerate)
        self.resamp = RationalResampler(in_samplerate, out_samplerate)
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.fir = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate))
        self.ratio = self.resamp.ratio
        self.in_multiple = self.resamp.in_multiple

    def make_params(self, offset_hz):
        """Per-call retune; ``offset_hz`` may be per-channel."""
        return {"xl": nco_params(-np.asarray(offset_hz, np.float64),
                                 self.in_samplerate)}

    def init_params(self):
        return self.make_params(self.offset_hz)

    def init_state(self, batch_shape=()):
        st = {"xl": self.xlator.init_state(batch_shape),
              "rs": self.resamp.init_state(batch_shape)}
        if self.filter_needed:
            st["fir"] = self.fir.init_state(batch_shape)
        return st

    def apply(self, params, state, x):
        if params is None:
            params = self.init_params()
        st = dict(state)
        y, st["xl"] = self.xlator.apply(params["xl"], state["xl"], x)
        y, st["rs"] = self.resamp.apply(None, state["rs"], y)
        if self.filter_needed:
            y, st["fir"] = self.fir.apply(None, state["fir"], y)
        return y, st


class SharedRxVFOBank(Block):
    """RxVFO over a SHARED wideband: per-channel mix-down folded into the
    first predecimation stage (ops/fused_frontend.py), the rest of the
    chain on the decimated planes, all in kernel K1."""

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float):
        from ..ops.fused_frontend import SharedXlateDecimFIR
        self.base = RxVFO(in_samplerate, out_samplerate, bandwidth)
        self.in_samplerate = float(in_samplerate)
        blocks = self.base.resamp.chain.named_blocks
        if not (blocks and blocks[0][0] == "decim"):
            raise NotImplementedError("shared bank without predecimation")
        stage0 = blocks[0][1].stages[0]
        self.fused = SharedXlateDecimFIR(stage0.taps, in_samplerate,
                                         stage0.decim)
        self.rest_decim = blocks[0][1].stages[1:]
        self.rest = [(n, b) for n, b in blocks if n != "decim"]
        self.ratio = self.base.ratio
        self.in_multiple = self.base.in_multiple
        self.filter_needed = self.base.filter_needed
        self._pipe = None

    def make_params(self, offsets_hz):
        from ..ops.fused_frontend import fused_params
        return {"fused": fused_params(np.asarray(offsets_hz, np.float64),
                                      self.in_samplerate, self.fused.decim)}

    def init_state(self, C: int):
        st = {"fused": self.fused.init_state((C,)),
              "rest_decim": [s.init_state((C,)) for s in self.rest_decim]}
        for n, b in self.rest:
            st[n] = b.init_state((C,))
        if self.filter_needed:
            st["fir"] = self.base.fir.init_state((C,))
        return st

    def mono_pipe(self):
        if self._pipe is None:
            from ..ops.mono_frontend import MonoVFOPipeline
            self._pipe = MonoVFOPipeline(self)
        return self._pipe

    def apply(self, params, state, x):
        """x: [T] shared wideband, complex64 or (xr, xi) float32 planes →
        (IF planes [2C, T·ratio] in the handoff dtype — re rows then im
        rows — and the new state)."""
        if not isinstance(x, tuple):
            x = (x.real, x.imag)
        return self.mono_pipe().apply(params["fused"], state, x)
