"""DAB decoder module — OFDM front end with constellation/CFO products
(counterpart of sdrplusplusbrown_tpu/modules/dab_module.py).

reference: decoder_modules/dab_decoder/src/main.cpp — 2.048 MS/s VFO →
CyclicSync → FrameFreqSync → constellation display.  The upstream stops
at the constellation (no FIC/MSC Viterbi); this module matches that
scope and also surfaces the per-symbol time-differential DQPSK dibits.
The VFO (where the source is wider than 2.048 MS/s) runs on the app's
device and its output crosses to the host in one copy a block; at the
channel rate the baseband stays on the host, where the OFDM front end
runs, as in the JAX module.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.dab import CyclicSync, FrameFreqSync, DAB_SR
from .decoder_feed import ChannelFeed

DAB_VFO_BW = 1_712_000.0


class DABDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.csync = CyclicSync()
        self.ffsync = FrameFreqSync()
        self._sym_read = 0
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "dab_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        feed = ChannelFeed(self.app, DAB_SR, DAB_VFO_BW, self.offset_hz,
                           10, vfo=sr > DAB_SR, block_sr=min(sr, DAB_SR))
        self.feed, self.rc = feed, feed.rc

    def process_iq(self, iq: np.ndarray):
        for chunk in self.rc.push(iq):
            with self._mtx:
                if self.feed.chan is not None:
                    chunk = self.feed.channel(chunk).cpu().numpy()
                self.csync.push(chunk)
                while self._sym_read < len(self.csync.symbols):
                    i = self._sym_read
                    self.ffsync.push_symbol(self.csync.symbols[i],
                                            pos=self.csync.positions[i])
                    self._sym_read += 1
                # bound memory
                if self._sym_read > 4096:
                    del self.csync.symbols[:self._sym_read]
                    del self.csync.positions[:self._sym_read]
                    self._sym_read = 0
                self.ffsync.constellations = \
                    self.ffsync.constellations[-128:]

    def _on_baseband(self, iq: np.ndarray):
        if self.is_enabled():
            self.process_iq(iq)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"symbols": len(self.csync.symbols),
                    "frames": self.ffsync.frames_seen,
                    "cfo_hz": round(self.ffsync.last_cfo_hz, 1)}
        if cmd == "get_constellation":
            if not self.ffsync.constellations:
                return {"points": []}
            c = self.ffsync.constellations[-1][:256]
            return {"points": [[round(float(v.real), 4),
                                round(float(v.imag), 4)] for v in c]}
        if cmd == "get_dibits":
            dm = self.ffsync.demap_time_differential()
            if not dm:
                return {"dibits": []}
            return {"dibits": dm[-1][:128].tolist()}
        return super().handle_debug_command(cmd, args)
