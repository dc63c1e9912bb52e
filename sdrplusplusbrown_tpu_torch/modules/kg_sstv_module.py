"""KG-SSTV decoder module (counterpart of
sdrplusplusbrown_tpu/modules/kg_sstv_module.py).

reference: decoder_modules/kg_sstv_decoder/src/main.cpp — VFO into
kgsstv::Decoder; upstream writes raw frame bytes to kgsstv_out.bin;
here frames surface over the debug command plane.  The VFO (where the
baseband is wider than the channel), the demod and the Viterbi run on the
app's device.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.kg_sstv import KGSSTVDemod, KGSSTVDeframer
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

KGSSTV_VFO_SR = 24_000.0


class KGSSTVDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.deframer = KGSSTVDeframer(device=app.device)
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "kg_sstv_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        vfo = sr > KGSSTV_VFO_SR
        feed = ChannelFeed(self.app, KGSSTV_VFO_SR, KGSSTV_VFO_SR,
                           self.offset_hz, 4, vfo=vfo)
        dem = KGSSTVDemod(KGSSTV_VFO_SR if vfo else sr)
        with self._mtx:
            self.feed, self.dem, self.rc = feed, dem, feed.rc
            self.dem_state = to_device(dem.init_state(()), feed.device)

    def process_iq(self, iq: np.ndarray):
        for chunk in self.feed.blocks(iq):
            with self._mtx:
                (sym, valid), self.dem_state = self.dem.apply(
                    None, self.dem_state, self.feed.channel(chunk))
            self.deframer.push_symbols(sym[valid].cpu().numpy())

    def _on_baseband(self, iq: np.ndarray):
        if self.is_enabled():
            self.process_iq(iq)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"frames": self.deframer.frames_seen}
        if cmd == "get_frames":
            return {"frames": [f.hex() for f in
                               self.deframer.frames[-16:]]}
        return super().handle_debug_command(cmd, args)
