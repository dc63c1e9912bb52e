"""Transmit path: Transmitter interface, TX audio chain, prebuffer
(counterpart of sdrplusplusbrown_tpu/models/trx.py).

reference: core/src/trx.h:14-47 (abstract Transmitter: PTT, gains, tune,
SWR/power telemetry — implemented by hl2_source), server.cpp:113-123 (the
server TX path: 6 kHz wire-rate client audio → upsample to 48 kHz →
Prebuffer → Packer → transmitter), dsp/buffer/prebuffer.h.

The DSP runs on the port's blocks: ``TxChain``'s AGC on K12 and its
modulator (``SSBMod``'s complex band-pass on K9), ``ServerTxPath``'s
6 k → 48 k ``RationalResampler`` on K8, each on a CUDA tensor; on a CPU
tensor their plain versions.  The prebuffer and the transmitters are
host code.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..runtime.block import Block, entry_device
from ..ops.mod import QuadratureMod, SSBMod, AMMod
from ..ops.resampler import RationalResampler
from ..ops.agc import AGC

TX_WIRE_SAMPLERATE = 6000.0   # reference server_protocol.h:11
TX_PACKET = 960               # 20 ms at 48 kHz (the reference Packer)


class Transmitter:
    """Abstract TX hardware interface (reference trx.h:14-47)."""

    def set_ptt(self, ptt: bool):
        raise NotImplementedError

    def get_ptt(self) -> bool:
        raise NotImplementedError

    def set_tx_frequency(self, freq: float):
        raise NotImplementedError

    def set_tx_gain(self, gain: float):
        raise NotImplementedError

    def send_iq(self, iq: np.ndarray):
        """Push a block of TX baseband IQ at 48 kHz."""
        raise NotImplementedError

    # telemetry (reference trx.h:39-43)
    def get_forward_power(self) -> float:
        return 0.0

    def get_reflected_power(self) -> float:
        return 0.0

    def get_swr(self) -> float:
        fwd, ref = self.get_forward_power(), self.get_reflected_power()
        if fwd <= 0:
            return 1.0
        rho = min(np.sqrt(ref / fwd), 0.999)
        return float((1 + rho) / (1 - rho))


class LoopbackTransmitter(Transmitter):
    """Captures TX IQ in memory (tests / null hardware)."""

    def __init__(self):
        self.ptt = False
        self.freq = 0.0
        self.gain = 1.0
        self.blocks = []
        self._mtx = threading.Lock()

    def set_ptt(self, ptt: bool):
        self.ptt = bool(ptt)

    def get_ptt(self) -> bool:
        return self.ptt

    def set_tx_frequency(self, freq: float):
        self.freq = float(freq)

    def set_tx_gain(self, gain: float):
        self.gain = float(gain)

    def send_iq(self, iq: np.ndarray):
        with self._mtx:
            self.blocks.append(np.asarray(iq))

    def get_forward_power(self) -> float:
        return 10.0 * self.gain


class TxChain(Block):
    """Audio (real 48 kHz) → modulated TX baseband IQ: the AGC (K12),
    then the modulator.

    Modes: FM (quadrature phasor), USB/LSB (analytic band-pass, K9), AM.
    """

    def __init__(self, mode: str = "USB", samplerate: float = 48_000.0,
                 bandwidth: float = 2_800.0, fm_deviation: float = 5_000.0):
        self.mode = mode.upper()
        self.samplerate = float(samplerate)
        self.agc = AGC(set_point=1.0, attack=50.0 / samplerate,
                       decay=5.0 / samplerate, max_gain=100.0)
        if self.mode == "FM" or self.mode == "NFM":
            self.mod = QuadratureMod(fm_deviation, samplerate)
        elif self.mode == "USB":
            self.mod = SSBMod(SSBMod.USB, bandwidth, samplerate)
        elif self.mode == "LSB":
            self.mod = SSBMod(SSBMod.LSB, bandwidth, samplerate)
        elif self.mode == "AM":
            self.mod = AMMod()
        else:
            raise ValueError(f"unknown TX mode {mode}")

    def init_state(self, batch_shape=()):
        return {"agc": self.agc.init_state(batch_shape),
                "mod": self.mod.init_state(batch_shape)}

    def apply(self, params, state, audio):
        y, ags = self.agc.apply(None, state["agc"], audio)
        iq, ms = self.mod.apply(None, state["mod"], y)
        return iq, {"agc": ags, "mod": ms}


class Prebuffer:
    """Latency buffer: hold ``prebuffer_ms`` of samples before releasing a
    steady stream (reference dsp/buffer/prebuffer.h — smooths network
    jitter on the TX path)."""

    def __init__(self, samplerate: float, prebuffer_ms: float = 200.0):
        self.samplerate = float(samplerate)
        self.target = int(samplerate * prebuffer_ms / 1000.0)
        self._buf = np.zeros(0, np.complex64)
        self._primed = False

    def push(self, x: np.ndarray):
        self._buf = np.concatenate([self._buf, np.asarray(x)])

    def pull(self, n: int) -> Optional[np.ndarray]:
        if not self._primed:
            if len(self._buf) < self.target:
                return None
            self._primed = True
        if len(self._buf) < n:
            self._primed = False     # underrun: re-prime
            return None
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class ServerTxPath:
    """Server-side TX: 6 kHz wire audio → 48 kHz → transmitter (reference
    server.cpp:113-123).  The resampler runs on ``device`` (CUDA unless
    the caller asks for the CPU) with its state kept there; each wire
    block goes to the device once and its 48 kHz output comes back in one
    copy, into the host prebuffer, drained in 960-sample packets."""

    def __init__(self, transmitter: Transmitter, mode: str = "USB",
                 prebuffer_ms: float = 200.0, device="cuda"):
        self.transmitter = transmitter
        self.device = entry_device(device)
        self.resamp = RationalResampler(TX_WIRE_SAMPLERATE, 48_000.0)
        self.rs_state = {k: v.to(self.device) for k, v in
                         self.resamp.init_state((), torch.complex64).items()}
        self.prebuffer = Prebuffer(48_000.0, prebuffer_ms)
        # one client's blocks at a time: the carried tail is one stream
        self._mtx = threading.Lock()

    def push_wire_block(self, iq6k: np.ndarray):
        n = len(iq6k)
        g = self.resamp.in_multiple
        n_pad = ((n + g - 1) // g) * g
        if n_pad != n:
            iq6k = np.pad(iq6k, (0, n_pad - n))
        x = torch.from_numpy(np.ascontiguousarray(iq6k, np.complex64))
        with self._mtx:
            up, self.rs_state = self.resamp.apply(
                None, self.rs_state, x.to(self.device))
            self.prebuffer.push(up.cpu().numpy())
            # drain in 20 ms packets (the reference Packer granularity)
            while True:
                pkt = self.prebuffer.pull(TX_PACKET)
                if pkt is None:
                    break
                self.transmitter.send_iq(pkt)
