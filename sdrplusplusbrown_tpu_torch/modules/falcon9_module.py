"""Falcon-9 telemetry decoder module (counterpart of
sdrplusplusbrown_tpu/modules/falcon9_module.py).

reference: decoder_modules/falcon9_decoder/src/main.cpp — 6 MS/s VFO →
FSK demod → deframe → RS → packet sync; upstream pipes packets into a
zstd-compressed video/TLM parser (vendored, out of scope) — here the
raw packets surface over the debug command plane.  The VFO (where the
source is wider than 6 MS/s) and the demod run on the app's device; each
block's hard bits cross to the host in one copy for the deframer, the RS
and the packet layer.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.falcon9 import (FalconDemod, FalconDeframer,
                              FalconPacketSync, falcon_rs_decode,
                              FALCON_SR)
from ..ops.digital import valid_hard_bits
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

FALCON_VFO_BW = 4_000_000.0


class Falcon9DecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.deframer = FalconDeframer()
        self.pkt_sync = FalconPacketSync()
        self.frames_ok = 0
        self.frames_bad = 0
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "falcon9_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        feed = ChannelFeed(self.app, FALCON_SR, FALCON_VFO_BW,
                           self.offset_hz, 10, vfo=sr > FALCON_SR,
                           block_sr=min(sr, FALCON_SR))
        dem = FalconDemod()
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.dem = dem
            self.dem_state = to_device(dem.init_state(()), feed.device)

    def process_iq(self, iq: np.ndarray):
        for chunk in self.rc.push(iq):
            with self._mtx:
                (sym, valid), self.dem_state = self.dem.apply(
                    None, self.dem_state, self.feed.channel(chunk))
            self.deframer.push_bits(valid_hard_bits(sym, valid))
            while self.deframer.frames:
                fr = self.deframer.frames.pop(0)
                out = falcon_rs_decode(fr)
                if out is None:
                    self.frames_bad += 1
                    continue
                self.frames_ok += 1
                self.pkt_sync.push_frame(out)

    def _on_baseband(self, iq: np.ndarray):
        if self.is_enabled():
            self.process_iq(iq)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"frames_ok": self.frames_ok,
                    "frames_bad": self.frames_bad,
                    "packets": len(self.pkt_sync.packets)}
        if cmd == "get_packets":
            n = 8
            try:
                n = int(args) if args.strip() else 8
            except ValueError:
                pass
            return {"packets": [p.hex() for p in
                                self.pkt_sync.packets[-n:]]}
        return super().handle_debug_command(cmd, args)
