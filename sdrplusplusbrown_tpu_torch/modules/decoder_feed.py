"""The decoder modules' input (the M17, KG-SSTV, RyFi, Meteor, VOR,
weather-satellite, ATV, Falcon 9 and DAB modules): the app's host baseband
(``app.baseband_event``, or a module's ``process_iq``), rechunked into
blocks of about 1/``per_second`` s aligned to the channel's granularity,
each block moved to the app's device and, where the module needs one,
through an ``RxVFO`` to the decoder's channel rate (K8/K9 on the card).
The JAX modules run the same chain under ``jax.jit``; here the blocks are
called directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.rx_vfo import RxVFO
from ..runtime.block import Chain, to_device
from ..runtime.pump import Rechunker


class ChannelFeed:
    def __init__(self, app, out_sr: float, bandwidth: float,
                 offset_hz: float, per_second: int | None, vfo: bool = True,
                 block_sr: float | None = None, decoder=None):
        """``vfo`` False: no RxVFO (the decoder takes the baseband as it
        is).  The block is 1/``per_second`` of ``block_sr`` samples (the
        source rate by default), rounded up to the granularity of the
        RxVFO and of ``decoder`` (a block after it whose windows a block
        must hold whole, as VOR's); ``per_second`` None: one granule."""
        sr = app.frontend.effective_sr
        self.device = app.device
        self.chan = RxVFO(sr, out_sr, bandwidth, offset_hz=offset_hz) \
            if vfo else None
        g = 1
        if self.chan is not None:
            self.set_offset(offset_hz)
            self.state = to_device(self.chan.init_state(()), self.device)
            g = self.chan.in_multiple
        if decoder is not None:
            g = Chain([("chan", self.chan), ("dec", decoder)]).in_multiple \
                if self.chan is not None else decoder.in_multiple
        span = int(sr if block_sr is None else block_sr)
        blk = g if per_second is None else \
            ((span // per_second + g - 1) // g) * g
        self.rc = Rechunker(max(blk, g))

    def set_offset(self, offset_hz: float):
        self.params = to_device(self.chan.make_params(offset_hz),
                                self.device)

    def blocks(self, iq: np.ndarray) -> list:
        """The whole blocks ``iq`` completes (host arrays)."""
        return self.rc.push(iq)

    def channel(self, block: np.ndarray) -> torch.Tensor:
        """A block on the device at the channel rate."""
        x = torch.from_numpy(np.ascontiguousarray(block, np.complex64)) \
            .to(self.device)
        if self.chan is None:
            return x
        y, self.state = self.chan.apply(self.params, self.state, x)
        return y
