"""VOR receiver module — tunes a 25 kHz channel on the wideband baseband
and publishes bearing/quality over the control plane (counterpart of
sdrplusplusbrown_tpu/modules/vor_module.py).

reference: decoder_modules/vor_receiver/src/main.cpp:29-106 — the module
creates a 25 kHz VFO, feeds vor::Decoder(integrationTime=1) and renders
`Bearing`/`Quality`; here those surface as debug commands.  The VFO and
the decoder run on the app's device, a block of whole integration
windows at a time (the JAX module's ``Rechunker(chain.in_multiple)``);
each block's bearings and qualities cross to the host in one copy.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..app import ModuleInstance
from ..models.vor import VORDecoder, VOR_IN_SR
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed


class VORReceiverModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0,
                 integration_time: float = 1.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self.integration_time = float(integration_time)
        self._mtx = threading.Lock()
        self.bearing_deg = 0.0
        self.quality = 0.0
        self.windows = 0
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "vor_receiver"

    def _build(self):
        dec = VORDecoder(self.integration_time)
        feed = ChannelFeed(self.app, VOR_IN_SR, VOR_IN_SR, self.offset_hz,
                           None, decoder=dec)
        with self._mtx:
            self.dec = dec
            self.feed, self.rc = feed, feed.rc
            self.state = to_device(dec.init_state(()), feed.device)

    def set_offset(self, offset_hz: float):
        with self._mtx:
            self.offset_hz = float(offset_hz)
            self.feed.set_offset(self.offset_hz)

    def _on_baseband(self, iq: np.ndarray):
        if not self.is_enabled():
            return
        for chunk in self.rc.push(iq):
            with self._mtx:
                (bear, qual), self.state = self.dec.apply(
                    None, self.state, self.feed.channel(chunk))
            b, q = torch.stack([bear, qual]).cpu().numpy()
            if b.size:
                self.bearing_deg = float(np.rad2deg(b[-1]))
                self.quality = float(q[-1])
                self.windows += int(b.size)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "get_bearing":
            return {"bearing": round(self.bearing_deg, 2),
                    "quality": round(self.quality * 100.0, 1),
                    "windows": self.windows}
        if cmd == "set_offset":
            try:
                self.set_offset(float(args))
                return {"status": "ok", "offset": self.offset_hz}
            except ValueError:
                return {"error": f"bad offset '{args}'"}
        return super().handle_debug_command(cmd, args)
