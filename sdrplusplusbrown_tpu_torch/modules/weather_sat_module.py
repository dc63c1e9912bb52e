"""Weather satellite decoder module — NOAA HRPT to AVHRR image lines
(counterpart of sdrplusplusbrown_tpu/modules/weather_sat_module.py).

reference: decoder_modules/weather_sat_decoder/src/{main.cpp,
noaa_hrpt_decoder.h} — a 3 MHz / 2 MHz-bandwidth VFO into the PM demod +
Manchester deframer + HRPT demux; AVHRR channels render as val·255/1024
grayscale lines and an RGB(221) composite (noaa_hrpt_decoder.h:291-389).
The VFO (where the source is wider than 3 MS/s) and the PM demod run on
the app's device; each block's hard symbol bits cross to the host in one
copy for the framer.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from ..app import ModuleInstance
from ..models.hrpt import (PMDemod, HRPTFramer, HRPT_VFO_SR,
                           AVHRR_PIXELS)
from ..ops.digital import valid_hard_bits
from ..runtime.block import to_device
from ..utils.flog import flog
from .decoder_feed import ChannelFeed

HRPT_VFO_BW = 2_000_000.0        # noaa_hrpt_decoder.h:13


class WeatherSatDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0,
                 max_lines: int = 1024):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self.max_lines = int(max_lines)
        self._mtx = threading.Lock()
        self.framer = HRPTFramer()
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "weather_sat_decoder"

    def _build(self):
        sr = self.app.frontend.effective_sr
        if sr < HRPT_VFO_SR:
            flog.warn("weather_sat[{}]: source rate {} < {} — feed the "
                      "3 MS/s channel via process_iq()", self.name, sr,
                      HRPT_VFO_SR)
        feed = ChannelFeed(self.app, HRPT_VFO_SR, HRPT_VFO_BW,
                           self.offset_hz, 10, vfo=sr > HRPT_VFO_SR,
                           block_sr=HRPT_VFO_SR)
        dem = PMDemod()
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.dem = dem
            self.dem_state = to_device(dem.init_state(()), feed.device)

    def process_iq(self, iq: np.ndarray):
        """Feed 3 MS/s channel IQ directly (also the baseband path when
        the source is at 3 MS/s or above)."""
        for chunk in self.rc.push(iq):
            with self._mtx:
                (sym, valid), self.dem_state = self.dem.apply(
                    None, self.dem_state, self.feed.channel(chunk))
            before = self.framer.frames
            self.framer.push_symbols(valid_hard_bits(sym, valid))
            if self.framer.frames > before:
                flog.info("weather_sat[{}]: {} HRPT frames", self.name,
                          self.framer.frames)
            if len(self.framer.avhrr_lines) > self.max_lines:
                del self.framer.avhrr_lines[:-self.max_lines]
                del self.framer.tip[:-self.max_lines]

    def _on_baseband(self, iq: np.ndarray):
        if not self.is_enabled():
            return
        if self.app.frontend.effective_sr >= HRPT_VFO_SR:
            self.process_iq(iq)

    # -- image products -------------------------------------------------
    def gray_line(self, channel: int, line: int) -> List[int]:
        """AVHRR channel line as 8-bit grayscale (val·255/1024,
        noaa_hrpt_decoder.h:315-327)."""
        pix = self.framer.avhrr_lines[line][channel]
        return (pix.astype(np.float32) * 255.0 / 1024.0) \
            .astype(np.uint8).tolist()

    def rgb221_line(self, line: int) -> List[List[int]]:
        """RGB(221) composite: R=G=ch2, B=ch1 (noaa_hrpt_decoder.h:
        298-307)."""
        ln = self.framer.avhrr_lines[line]
        b = (ln[0].astype(np.float32) * 255.0 / 1024.0).astype(np.uint8)
        rg = (ln[1].astype(np.float32) * 255.0 / 1024.0).astype(np.uint8)
        return np.stack([rg, rg, b], axis=-1).tolist()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            return {"frames": self.framer.frames,
                    "lines": len(self.framer.avhrr_lines),
                    "pixels_per_line": AVHRR_PIXELS}
        if cmd == "get_line":
            try:
                ch, line = (int(v) for v in args.split(","))
                return {"channel": ch, "line": line,
                        "pixels": self.gray_line(ch, line)[:64]}
            except (ValueError, IndexError):
                return {"error": f"bad 'channel,line' args '{args}'"}
        if cmd == "get_tip":
            try:
                line = int(args)
                return {"line": line,
                        "tip": self.framer.tip[line][:32].tolist()}
            except (ValueError, IndexError):
                return {"error": f"bad line '{args}'"}
        return super().handle_debug_command(cmd, args)
