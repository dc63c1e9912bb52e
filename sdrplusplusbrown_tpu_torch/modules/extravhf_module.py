"""ExtraVHF decoder module: a 12.5 kHz DMR / P25 / D-STAR / NXDN 4FSK
channel → DSD-style frame sync and the burst layer past it, and the
channel's subaudible CTCSS tone and DCS code (counterpart of
sdrplusplusbrown_tpu/modules/extravhf_module.py).

reference: decoder_modules/ch_extravhf_decoder — its vendored DSD
stack demodulates the 12.5 kHz channel (dsd_demod.cpp's dmrFilt +
slicer), runs ``findFrameSync`` over the dibit stream
(dsd_demod.cpp:136) and latches the frame state the burst processors
consume; the vendored AMBE voice payload stack stays out of scope.

On the app's device: the RxVFO to 16 kS/s (K8), ``FourFSKDemod`` (K8,
K13m's real form at 3.33 samples a symbol), the discriminator audio
(``Quadrature``) and the CTCSS Goertzel bank (one matmul).  A 0.1 s block
crosses to the host in one copy: its audio, its CTCSS powers and its
valid dibits, for the burst layer (``DMRBurstProcessor``, whose frame
sync correlates on the device and whose D-STAR headers decode on K16)
and the host DCS detector.  The block is the JAX module's, ⌈0.1 s / g⌉·g
samples of the source (g the RxVFO's granularity): ``FourFSKDemod``'s
slicer levels are a per-block estimate.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..app import ModuleInstance
from ..models.dmr_burst import DMRBurstProcessor
from ..ops.ctcss import CTCSSDetector, DCSDetector
from ..ops.demod import Quadrature
from ..ops.demod_digital import FourFSKDemod
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

DMR_IF_SR = 16_000.0
DMR_BW = 12_500.0
DMR_SYMBOLRATE = 4_800.0
DMR_DEVIATION = 1_944.0


class ExtraVhfDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        # the burst layer past frame sync (its summary() is a superset of
        # DSDFrameSync's)
        self.burst = DMRBurstProcessor(device=app.device)
        self.sync = self.burst.sync
        # analog subaudible squelch decoders (reference ctcss.h/dcs.h)
        # fed from the discriminator audio of the same channel
        self.ctcss = CTCSSDetector(DMR_IF_SR, device=app.device)
        self.dcs = DCSDetector(DMR_IF_SR)
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "ch_extravhf_decoder"

    def _build(self):
        feed = ChannelFeed(self.app, DMR_IF_SR, DMR_BW, self.offset_hz, 10)
        dem = FourFSKDemod(DMR_SYMBOLRATE, DMR_IF_SR, DMR_DEVIATION)
        quad = Quadrature(DMR_DEVIATION, DMR_IF_SR)
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.dem, self.quad = dem, quad
            self.dstate = to_device(dem.init_state(()), feed.device)
            self.qstate = to_device(quad.init_state(()), feed.device)

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
                (_, dibit, valid), self.dstate = self.dem.apply(
                    None, self.dstate, y)
                audio, self.qstate = self.quad.apply(None, self.qstate, y)
                powers = self.ctcss.stage(audio)
            # one copy: the audio, the CTCSS powers, the dibits (-1 where
            # no symbol)
            na, npw = audio.shape[-1], powers.numel()
            host = torch.cat([audio.reshape(-1), powers.reshape(-1),
                              torch.where(valid, dibit.to(torch.float32),
                                          -1.0)]).cpu().numpy()
            af = host[:na]
            d = host[na + npw:]
            db = d[d >= 0].astype(np.int32)
            if db.size:
                self.burst.push(db)
            if npw:
                self.ctcss.take(host[na:na + npw])
            self.dcs.push(af)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            out = self.burst.summary()
            out["ctcss"] = self.ctcss.summary()
            out["dcs"] = self.dcs.summary()
            return out
        if cmd == "set_offset":
            self.set_offset(float(args))
            return {"status": "ok", "offset": self.offset_hz}
        return super().handle_debug_command(cmd, args)
