"""Meteor-M LRPT demodulator module — 150 kHz channel → soft-symbol
.s recordings for external LRPT decoders (LRPTOfflineDecoder/meteor_dec)
(counterpart of sdrplusplusbrown_tpu/modules/meteor_module.py).

reference: decoder_modules/meteor_demodulator/src/main.cpp — VFO at
150 kHz, dsp::demod::Meteor(72k/80k sym/s, broken-modulation and OQPSK
toggles), soft symbols written as interleaved int8 (×84, clamped ±127,
main.cpp:199-202) into `meteor_<timestamp>.s` files.  The VFO and the
demod run on the app's device; the int8 conversion and the file on the
host.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..app import ModuleInstance
from ..models.meteor import MeteorDemod, METEOR_IN_SR, soft_to_int8
from ..runtime.block import to_device
from ..utils.flog import flog
from .decoder_feed import ChannelFeed


class MeteorDemodulatorModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0,
                 symbolrate: float = 72_000.0,
                 broken_modulation: bool = False, oqpsk: bool = False,
                 directory: str | None = None):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self.symbolrate = float(symbolrate)
        self.broken = bool(broken_modulation)
        self.oqpsk = bool(oqpsk)
        self.directory = directory or os.path.join(app.root, "recordings")
        self._mtx = threading.Lock()
        self._file = None
        self.record_path = ""
        self.written = 0
        self.constellation = np.zeros(0, np.complex64)
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "meteor_demodulator"

    def _build(self):
        # feed ~0.1 s per call, aligned to the channelizer granularity
        feed = ChannelFeed(self.app, METEOR_IN_SR, METEOR_IN_SR,
                           self.offset_hz, 10)
        dem = MeteorDemod(symbolrate=self.symbolrate,
                          broken_modulation=self.broken, oqpsk=self.oqpsk)
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.dem = dem
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
                (sym, valid), self.dem_state = self.dem.apply(
                    None, self.dem_state, self.feed.channel(chunk))
            s = sym[valid].cpu().numpy()
            if not s.size:
                continue
            self.constellation = s[-1024:]
            with self._mtx:
                if self._file is not None:
                    payload = soft_to_int8(s)
                    self._file.write(payload.tobytes())
                    self.written += s.size

    def start_recording(self) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory,
            time.strftime("meteor_%d_%m_%Y_%H_%M_%S.s"))
        with self._mtx:
            if self._file is not None:
                self._file.close()
            self._file = open(path, "wb")
            self.record_path = path
            self.written = 0
        flog.info("meteor[{}]: recording to {}", self.name, path)
        return path

    def stop_recording(self):
        with self._mtx:
            if self._file is not None:
                self._file.close()
                self._file = None

    def shutdown(self):
        self.stop_recording()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "set_offset":
            try:
                self.set_offset(float(args))
                return {"status": "ok", "offset": self.offset_hz}
            except ValueError:
                return {"error": f"bad offset '{args}'"}
        if cmd == "set_symbolrate":
            try:
                sr = float(args)
            except ValueError:
                return {"error": f"bad symbolrate '{args}'"}
            if sr not in (72_000.0, 80_000.0):
                return {"error": "symbolrate must be 72000 or 80000"}
            self.symbolrate = sr
            self._build()
            return {"status": "ok", "symbolrate": sr}
        if cmd in ("set_broken", "set_oqpsk"):
            on = args.strip().lower() in ("1", "true", "on")
            if cmd == "set_broken":
                self.broken = on
            else:
                self.oqpsk = on
            self._build()
            return {"status": "ok", cmd[4:]: on}
        if cmd == "start_record":
            return {"status": "ok", "path": self.start_recording()}
        if cmd == "stop_record":
            self.stop_recording()
            return {"status": "ok", "written": self.written}
        if cmd == "get_status":
            c = self.constellation
            return {"symbolrate": self.symbolrate, "broken": self.broken,
                    "oqpsk": self.oqpsk, "written": self.written,
                    "recording": self._file is not None,
                    "constellation_amp": float(np.mean(np.abs(c)))
                    if c.size else 0.0}
        return super().handle_debug_command(cmd, args)
