"""RyFi decoder module — receives the fork's wideband QPSK data link and
surfaces packets over the control plane (counterpart of
sdrplusplusbrown_tpu/modules/ryfi_module.py).

reference: decoder_modules/ryfi_decoder/src/main.cpp — VFO over the
RyFi channel into ryfi::Receiver; received packets stream out (upstream
feeds a TUN device; here the packet bytes surface over debug commands).
The VFO (where the baseband is wider than the channel), the demod and the
Viterbi run on the app's device; the deframer and RS on the host.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.ryfi import RyfiReceiver
from ..utils.flog import flog
from .decoder_feed import ChannelFeed


class RyfiDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0,
                 baudrate: float = 720_000.0,
                 channel_sr: float = 1_500_000.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self.baudrate = float(baudrate)
        self.channel_sr = float(channel_sr)
        self._mtx = threading.Lock()
        self.packets: list = []
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "ryfi_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        vfo = sr > self.channel_sr
        feed = ChannelFeed(self.app, self.channel_sr, self.channel_sr,
                           self.offset_hz, 10, vfo=vfo)
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.rx = RyfiReceiver(self.baudrate,
                                   self.channel_sr if vfo else sr,
                                   device=self.app.device)

    def process_iq(self, iq: np.ndarray):
        for chunk in self.feed.blocks(iq):
            with self._mtx:
                new = self.rx.process(self.feed.channel(chunk))
            if new:
                self.packets.extend(new)
                self.packets = self.packets[-256:]
                flog.info("ryfi[{}]: {} packets", self.name,
                          len(self.packets))

    def _on_baseband(self, iq: np.ndarray):
        if self.is_enabled():
            self.process_iq(iq)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"frames": self.rx.frames_decoded,
                    "bad_frames": self.rx.frames_bad,
                    "lost_frames": self.rx.assembler.lost_frames,
                    "packets": len(self.packets)}
        if cmd == "get_packets":
            n = 16
            try:
                n = int(args) if args.strip() else 16
            except ValueError:
                pass
            return {"packets": [p.hex() for p in self.packets[-n:]]}
        return super().handle_debug_command(cmd, args)
