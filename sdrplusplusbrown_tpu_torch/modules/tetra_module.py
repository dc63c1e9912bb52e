"""TETRA demodulator module: 25 kHz channel → π/4-DQPSK → burst sync →
BSCH/AACH lower-MAC decode and the upper MAC's fragment reassembly
(counterpart of sdrplusplusbrown_tpu/modules/tetra_module.py).

reference: decoder_modules/ch_tetra_demodulator (osmo-tetra derived).
On the app's device: the RxVFO to 36 kS/s (K8) and ``Pi4DQPSKDemod``
(K12c, K8, K13m's complex form at 2 samples a symbol); each call's valid
dibits cross to the host in one copy for the downlink decoder
(models/tetra.py, host numpy).  A call is one granule of the RxVFO, as
in the JAX module (1 600 samples at 2.4 MS/s: 24 channel samples, 12
symbols): the demod's fourth-power carrier bias is a per-call estimate
that is not carried, so a longer block would give other dibits.  Status
surfaces the cell identity (colour code, MCC/MNC), TDMA time and
burst/CRC counters over the control plane, like the reference's status
commands."""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.tetra import TetraDownlinkDecoder
from ..ops.demod_digital import Pi4DQPSKDemod
from ..ops.digital import valid_dibits
from ..runtime.block import to_device
from .decoder_feed import ChannelFeed

TETRA_IF_SR = 36_000.0        # 2 samples/symbol at 18 ksym/s
TETRA_BW = 25_000.0


class TetraDemodulatorModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.decoder = TetraDownlinkDecoder()
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "ch_tetra_demodulator"

    def _build(self):
        feed = ChannelFeed(self.app, TETRA_IF_SR, TETRA_BW, self.offset_hz,
                           None)
        dem = Pi4DQPSKDemod(18_000.0, TETRA_IF_SR)
        with self._mtx:
            self.feed, self.rc = feed, feed.rc
            self.dem = dem
            self.dstate = to_device(dem.init_state(()), feed.device)

    def set_offset(self, offset_hz: float):
        with self._mtx:
            self.offset_hz = float(offset_hz)
            self.feed.set_offset(self.offset_hz)

    def _on_baseband(self, iq: np.ndarray):
        if not self.is_enabled():
            return
        for chunk in self.feed.blocks(iq):
            with self._mtx:
                (_, dibit, valid), self.dstate = self.dem.apply(
                    None, self.dstate, self.feed.channel(chunk))
            db = valid_dibits(dibit, valid)
            if db.size:
                self.decoder.push(db)

    @staticmethod
    def _clean(pdu):
        """JSON-safe copy (drops raw bit arrays)."""
        if pdu is None:
            return None
        return {k: v for k, v in pdu.items()
                if k not in ("sdu", "tmSdu")}

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        dec = self.decoder
        if cmd == "status":
            last = dec.sync_infos[-1].as_dict() if dec.sync_infos \
                else None
            done = dec.reassembler.completed
            return {"bursts": dec.bursts_seen,
                    "sync_decodes": len(dec.sync_infos),
                    "aach_decodes": len(dec.aach),
                    "cell": last,
                    "ndb_bursts": dec.ndb_seen,
                    "sch_hd_decodes": dec.sch_hd_decodes,
                    "sch_f_decodes": dec.sch_f_decodes,
                    "mac_pdu_counts": dict(dec.mac_pdu_counts),
                    "sysinfo": (self._clean(dec.sysinfo[-1])
                                if dec.sysinfo else None),
                    "tm_sdu_reassembled": len(done),
                    "last_tm_sdu": (self._clean(done[-1]) if done
                                    else None)}
        if cmd == "sysinfo":
            return {"sysinfo": [self._clean(p)
                                for p in dec.sysinfo[-20:]],
                    "mac_resource": [self._clean(p)
                                     for p in dec.mac_resource[-20:]]}
        if cmd == "tm_sdus":
            return {"tm_sdus": [self._clean(p) for p in
                                dec.reassembler.completed[-20:]]}
        if cmd == "sync_infos":
            return {"sync_infos": [s.as_dict()
                                   for s in dec.sync_infos[-50:]]}
        if cmd == "set_offset":
            self.set_offset(float(args))
            return {"status": "ok", "offset": self.offset_hz}
        return super().handle_debug_command(cmd, args)
