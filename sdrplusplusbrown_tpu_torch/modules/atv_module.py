"""ATV decoder module — analog PAL television to a 768×576 grayscale
frame buffer (counterpart of sdrplusplusbrown_tpu/modules/atv_module.py).

reference: decoder_modules/atv_decoder/src/main.cpp — 14.77 MS/s VFO →
FastAGC → amplitude demod → LineSync → level servo/field sync → image
(color path is disabled upstream; grayscale parity here).  The VFO (where
the source is wider than 14.77 MS/s) and the front end run on the app's
device, a block at a time of as many source samples as 1/25 s holds at
the channel rate (the JAX module's rule); each block's video crosses to
the host in one copy for the line loop.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.atv import ATVFrontEnd, LineSync, FrameAssembler, SAMPLE_RATE
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

ATV_VFO_BW = 7_000_000.0


class ATVDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.linesync = LineSync()
        self.assembler = FrameAssembler()
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "atv_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        feed = ChannelFeed(self.app, SAMPLE_RATE, ATV_VFO_BW,
                           self.offset_hz, 25, vfo=sr > SAMPLE_RATE,
                           block_sr=min(sr, SAMPLE_RATE))
        fe = ATVFrontEnd()
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.fe = fe
            self.fe_state = to_device(fe.init_state(()), feed.device)

    def process_iq(self, iq: np.ndarray):
        for chunk in self.rc.push(iq):
            with self._mtx:
                v, self.fe_state = self.fe.apply(None, self.fe_state,
                                                 self.feed.channel(chunk))
            for line in self.linesync.push(v.cpu().numpy()):
                self.assembler.push_line(line)

    def _on_baseband(self, iq: np.ndarray):
        if self.is_enabled():
            self.process_iq(iq)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"h_locked": self.linesync.locked > 750,
                    "h_lock": self.linesync.locked,
                    "v_locked": self.assembler.vlock > 15,
                    "v_lock": self.assembler.vlock,
                    "lines": self.linesync.lines_out,
                    "frames": self.assembler.frames,
                    "gain": round(self.assembler.gain, 4),
                    "offset": round(self.assembler.offset, 4)}
        if cmd == "get_row":
            try:
                row = int(args)
                return {"row": row,
                        "pixels": self.assembler.image[row][:64]
                        .tolist()}
            except (ValueError, IndexError):
                return {"error": f"bad row '{args}'"}
        return super().handle_debug_command(cmd, args)
