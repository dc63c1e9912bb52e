"""M17 decoder module — 14.4 kHz channel → LSF callsigns + stream payloads
(counterpart of sdrplusplusbrown_tpu/modules/m17_module.py).

reference: decoder_modules/m17_decoder/src/main.cpp:31-120 — VFO at
14400 Hz / 9600 Hz bandwidth, dsp::M17Decoder with an LSF handler; the
codec2 voice path is vendored upstream and out of scope here (payload
bytes are surfaced over the debug command plane instead).  The VFO, the
demod and the Viterbi run on the app's device.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.m17 import M17Demod, M17FrameDecoder, DATA_TYPES, \
    ENCRYPTION_TYPES
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

M17_VFO_SR = 14_400.0          # reference main.cpp:31


class M17DecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.framer = M17FrameDecoder(device=app.device)
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "m17_decoder"

    def _build(self):
        feed = ChannelFeed(self.app, M17_VFO_SR, 9600.0, self.offset_hz, 10)
        dem = M17Demod(M17_VFO_SR)
        with self._mtx:
            self.feed, self.dem, self.rc = feed, dem, feed.rc
            self.dem_state = to_device(dem.init_state(()), feed.device)

    def set_offset(self, offset_hz: float):
        with self._mtx:
            self.offset_hz = float(offset_hz)
            self.feed.set_offset(self.offset_hz)

    def _on_baseband(self, iq: np.ndarray):
        if not self.is_enabled():
            return
        for chunk in self.feed.blocks(iq):
            with self._mtx:
                y = self.feed.channel(chunk)
                (bits, valid), self.dem_state = self.dem.apply(
                    None, self.dem_state, y)
            b = bits[valid].cpu().numpy()
            if b.size:
                self.framer.push_bits(b)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "set_offset":
            try:
                self.set_offset(float(args))
                return {"status": "ok", "offset": self.offset_hz}
            except ValueError:
                return {"error": f"bad offset '{args}'"}
        if cmd == "get_lsf":
            lsf = self.framer.lsf
            if lsf is None:
                return {"valid": False}
            return {"valid": True, "dst": lsf.dst, "src": lsf.src,
                    "stream": lsf.is_stream,
                    "data_type": DATA_TYPES[lsf.data_type],
                    "encryption": ENCRYPTION_TYPES[lsf.encryption_type],
                    "can": lsf.channel_access_num}
        if cmd == "get_stream":
            frames = self.framer.stream_frames[-16:]
            return {"frames": [{"fn": fn, "payload": by.hex()}
                               for fn, by in frames],
                    "total": len(self.framer.stream_frames)}
        return super().handle_debug_command(cmd, args)
