"""Hermes Lite 2 source + transmitter (openHPSDR protocol 1 / Metis) (a copy
of sdrplusplusbrown_tpu/io/hl2_source.py; host code, the same bytes on the
wire; the one change: ``HL2Source`` queues its RX samples in SR/200-sample
blocks, where the JAX source queues each 63-sample frame).

The HL2 is the reference fork's flagship TRX hardware: the only source
module that implements the ``Transmitter`` interface (RX IQ up to
384 kHz plus a 48 kHz TX IQ uplink with PTT/power/SWR telemetry over
one UDP socket).

reference: source_modules/hl2_source/src/hl2_device.h — register model,
Metis framing, 24-bit RX IQ decode, 16-bit TX IQ encode, RQST/ACK
frequency handshake, SWR math; protocol1_discovery.cpp:255-365,416-430 —
discovery broadcast and response layout; main.cpp — SourceManager wiring
and the Transmitter implementation; bandconfig.cpp:4-17 — band→filter
relay map.

Wire format (all packets UDP, device data port 1024):

* discovery: ``EF FE 02`` + 60 zero bytes → response ``EF FE <status>``
  with MAC at [3:9], gateware version at [9], board id at [10]
  (Hermes-Lite = 6; version ≥ 42 ⇒ HL2), max receivers at [0x13].
* data to device (endpoint 2): ``EF FE 01 <ep> <seq:u32be>`` + 2×512-byte
  HPSDR frames.  Each frame: ``7F 7F 7F C0 C1 C2 C3 C4`` + 63 8-byte
  sample groups (4 pad bytes + I:s16be + Q:s16be of TX IQ).  C0 =
  ``(register<<1) | MOX``; C1..C4 = 32-bit register value.
* data from device (endpoint 6): same framing; sample groups are
  ``I:s24be Q:s24be mic:s16be`` per receiver (63 groups at 1 RX);
  C0 bit 7 = ACK of a RQST'd register readback, else ``(C0>>3)&0x1F``
  selects a status group (0: ADC overload + TX fifo fill, 1: temperature
  + forward power, 2: reverse power).
* start/stop: ``EF FE 04 <1|0>`` + zeros (hl2_device.h:812-835).

This implementation replaces the reference's per-byte state machine
(hl2_device.h:669-760) with vectorized numpy frame codecs: an RX frame
decodes as one ``(63, 8)`` u8 reshape + sign-extended 24-bit gather, a
TX frame encodes as one scaled/clip-normalized s16be scatter.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .network_source import _QueueSource
from ..models.trx import Transmitter
from ..utils.flog import flog

DATA_PORT = 1024
SYNC = 0x7F
MAX_REGISTERS = 50

REG_TX_FREQ = 0x01
REG_RX_FREQ = 0x02            # hl2_device.h:38 REGISTER_RX_CENTER_FREQUENCY
REG_POWER = 0x09
REG_ADC_GAIN = 0x0A
REG_HANG_LATENCY = 0x17

SPEED_BITS = {48000: 0x00, 96000: 0x01, 192000: 0x02, 384000: 0x03}

#: frame-2 register round-robin (hl2_device.h:437)
SEND_REGISTERS = (0, 1, 2, 9, 0xA, 0x17, 9, 1, 2, 9, 2)

SAMPLES_PER_FRAME = 63        # (512-8)/8 at 1 receiver
FRAME_BYTES = 512
# the RX socket's receive buffer asked for: the receive loop is Python, and
# while another thread holds the interpreter the frames wait in the kernel,
# whose default buffer (~200 KB) holds ~40 ms of them at 384 kS/s and
# dropped the rest; the kernel caps the request at its rmem_max
RX_SOCKET_BUFFER = 4 << 20
FULL_SCALE_24 = 8388607.0     # 2^23-1 (hl2_device.h:720)

#: band label → (low Hz, high Hz, filter-board relay bits)
#: (bandconfig.cpp:4-17)
BAND_RELAYS: Tuple[Tuple[str, int, int, int], ...] = (
    ("160M", 0, 200_000, 1),
    ("80M", 200_000, 4_000_000, 2),
    ("60M", 4_000_000, 6_000_000, 4),
    ("40M", 6_000_000, 9_000_000, 4),
    ("30M", 9_000_000, 12_000_000, 8),
    ("20M", 12_000_000, 16_000_000, 8),
    ("17M", 16_000_000, 19_000_000, 16),
    ("15M", 19_000_000, 23_000_000, 16),
    ("12M", 23_000_000, 25_000_000, 32),
    ("10M", 25_000_000, 60_000_000, 32),
)


def relays_for_frequency(freq_hz: float) -> int:
    """Filter-board relay bits for a tune frequency (bandconfig.cpp:4-17)."""
    for _label, low, high, bits in BAND_RELAYS:
        if low <= freq_hz < high:
            return bits
    return 0


# ---------------------------------------------------------------------------
# frame codecs (vectorized equivalents of hl2_device.h:384-426, 657-760)
# ---------------------------------------------------------------------------

def decode_rx_frame(frame: np.ndarray, receivers: int = 1):
    """512-byte EP6 frame → (control[5] or None, iq[C, N] complex64, mic).

    Returns ``control`` as None when the sync prefix is absent (the
    reference state machine would hunt for sync; a desynced UDP frame is
    simply dropped here).
    """
    if not (frame[0] == SYNC and frame[1] == SYNC and frame[2] == SYNC):
        return None, np.zeros((receivers, 0), np.complex64), \
            np.zeros(0, np.int16)
    control = frame[3:8].copy()
    group = 6 * receivers + 2
    n = (FRAME_BYTES - 8) // group
    body = frame[8:8 + n * group].reshape(n, group)
    iq = np.empty((receivers, n), np.complex64)
    for r in range(receivers):
        col = body[:, 6 * r:6 * r + 6].astype(np.int32)
        i24 = (col[:, 0].astype(np.int8).astype(np.int32) << 16) \
            | (col[:, 1] << 8) | col[:, 2]
        q24 = (col[:, 3].astype(np.int8).astype(np.int32) << 16) \
            | (col[:, 4] << 8) | col[:, 5]
        iq[r] = (i24 / FULL_SCALE_24 + 1j * (q24 / FULL_SCALE_24)) \
            .astype(np.complex64)
    mic = ((body[:, -2].astype(np.int32) << 8) | body[:, -1]) \
        .astype(np.int16)
    return control, iq, mic


def encode_tx_samples(dest: np.ndarray, samples: np.ndarray, scale: float):
    """Write 63 TX IQ samples into a frame body (hl2_device.h:384-426).

    16-bit big-endian I/Q at bytes 4..7 of each 8-byte group; samples
    whose scaled amplitude exceeds 1.0 are renormalized per-sample (the
    reference's clip guard).  Returns the clipped-sample count.
    """
    n = len(samples)
    amp = np.abs(samples) * scale
    nscale = np.where(amp > 1.0, scale / np.maximum(amp, 1e-30), scale)
    i16 = (samples.real * nscale * 32767).astype(np.int32) & 0xFFFF
    q16 = (samples.imag * nscale * 32767).astype(np.int32) & 0xFFFF
    body = dest[:8 * n].reshape(n, 8)
    body[:, 4] = i16 >> 8
    body[:, 5] = i16 & 0xFF
    body[:, 6] = q16 >> 8
    body[:, 7] = q16 & 0xFF
    return int(np.count_nonzero(amp > 1.0))


# ---------------------------------------------------------------------------
# discovery (protocol1_discovery.cpp)
# ---------------------------------------------------------------------------

def discover(host: str = "255.255.255.255", port: int = DATA_PORT,
             timeout: float = 1.0) -> List[Dict]:
    """Broadcast a protocol-1 discovery and collect responses.

    Response layout per protocol1_discovery.cpp:264-352.
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.settimeout(timeout)
    pkt = bytearray(63)
    pkt[0], pkt[1], pkt[2] = 0xEF, 0xFE, 0x02   # :421-423
    found: List[Dict] = []
    try:
        sock.sendto(bytes(pkt), (host, port))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                raw, addr = sock.recvfrom(2048)
            except socket.timeout:
                break
            if len(raw) < 20 or raw[0] != 0xEF or raw[1] != 0xFE:
                continue
            status = raw[2]
            if status not in (2, 3, 28):        # :266-267
                continue
            version = raw[9]
            board = raw[10]
            dev = {
                "address": addr,
                "status": status,
                "mac": ":".join(f"{b:02x}" for b in raw[3:9]),
                "gateware_version": version,
                "board_id": board,
                "hl2_proxy": status == 28,
            }
            if board == 6:                      # Hermes-Lite family
                dev["name"] = ("Hermes Lite V2" if version >= 42
                               else "Hermes Lite V1")
                dev["supported_receivers"] = (raw[0x13] if version >= 42
                                              and len(raw) > 0x13 else 2)
            else:
                dev["name"] = {0: "Metis", 1: "Hermes", 2: "Angelia",
                               5: "Orion"}.get(board, "Unknown")
                dev["supported_receivers"] = 5
            found.append(dev)
    finally:
        sock.close()
    return found


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

class HL2Device:
    """Protocol-1 data-plane driver for one Hermes Lite 2.

    Owns the UDP socket and the register file; a receive thread decodes
    EP6 packets into IQ blocks (pushed to ``handler``) and telemetry; a
    pacer thread emits EP2 packets — register round-robin plus TX IQ —
    at the reference cadence (hl2_device.h:854-937): every ≥3 ms in RX,
    fifo-fill-level-gated during TX.
    """

    def __init__(self, address: Tuple[str, int],
                 handler: Callable[[np.ndarray], None],
                 rx_sample_rate: int = 384_000,
                 pacer_interval: float = 0.001):
        self.address = (address[0], address[1])
        self.handler = handler
        self.pacer_interval = float(pacer_interval)

        # register file (hl2_device.h:65-66)
        self.registers = np.zeros((MAX_REGISTERS, 4), np.uint8)
        self.dirty = np.zeros(MAX_REGISTERS, bool)

        self.running = False
        self.transmit_mode = False
        self.software_power = 255   # applied in software to TX samples
        self.hardware_power = 255
        self.tx_frequency = 0
        self.receivers = 1

        # telemetry (hl2_device.h:107-117)
        self.adc_overload = False
        self.fill_level = 0.0
        self._fill_update = 0.0
        self.alex_forward_power = 0
        self.alex_reverse_power = 0
        self.temperature = 0.0
        self.fwd = 0.0
        self.rev = 0.0
        self.swr = 1.0
        self.confirmed_frequency = -1
        self.clipped_tx_samples = 0

        # RQST/ACK handshake state (hl2_device.h:430-479)
        self._rqst_phase = 0
        self._rqst_count = 0

        self._send_seq = -1
        self._second_index = 1
        self._last_send = 0.0
        self._tx_lock = threading.Lock()
        self._tx_queue = np.zeros(0, np.complex64)

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                              RX_SOCKET_BUFFER)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.settimeout(0.1)
        self._threads: List[threading.Thread] = []

        # constructor defaults (hl2_device.h:144-156)
        self.set_adc_gain(0)
        self.set_frequency(7_000_000)
        self.set_hang_latency(6, 0x15)
        self.set_duplex(True)
        self.set_rx_sample_rate(rx_sample_rate)

    # -- register setters (semantics per hl2_device.h) ------------------
    def _set_u32(self, reg: int, value: int):
        self.registers[reg] = [(value >> 24) & 0xFF, (value >> 16) & 0xFF,
                               (value >> 8) & 0xFF, value & 0xFF]
        self.dirty[reg] = True

    def set_frequency(self, freq_hz: int):
        """RX center frequency; first call also seeds TX (h:192-206)."""
        self._set_u32(REG_RX_FREQ, int(freq_hz))
        if self.tx_frequency == 0:
            self.tx_frequency = int(freq_hz)
        self._set_u32(REG_TX_FREQ, self.tx_frequency)

    def set_tx_frequency(self, freq_hz: int):
        self.tx_frequency = int(freq_hz)
        self._set_u32(REG_TX_FREQ, self.tx_frequency)

    def set_rx_sample_rate(self, rate: int):
        if rate not in SPEED_BITS:
            raise ValueError(f"unsupported HL2 sample rate {rate}")
        self.registers[0, 0] = (self.registers[0, 0] & 0xFC) \
            | SPEED_BITS[rate]
        self.dirty[0] = True

    def get_rx_sample_rate(self) -> int:
        bits = int(self.registers[0, 0]) & 0x3
        return {v: k for k, v in SPEED_BITS.items()}[bits]

    def set_adc_gain(self, gain_db: int):
        """LNA gain −12..+48 dB mapped to a 6-bit field (h:176-182)."""
        self.registers[REG_ADC_GAIN, 3] = ((gain_db + 12) | 0x40) & 0xFF
        self.dirty[REG_ADC_GAIN] = True

    def set_hang_latency(self, ptt_hang_ms: int, buffer_latency_ms: int):
        self.registers[REG_HANG_LATENCY] = [0, 0, ptt_hang_ms & 0xFF,
                                            buffer_latency_ms & 0xFF]
        self.dirty[REG_HANG_LATENCY] = True

    def set_duplex(self, duplex: bool):
        self.registers[0, 3] = (self.registers[0, 3] & 0xFB) \
            | (0b100 if duplex else 0)

    def set_seven_relays(self, bits: int):
        """Filter-board relay bits, reg 0 C2 bits 1..7 (h:364-368)."""
        self.registers[0, 1] = (self.registers[0, 1] & 1) \
            | ((bits << 1) & 0xFF)
        self.dirty[0] = True

    def set_software_power(self, power: int):
        """0..255 TX scale applied in software to samples (h:208-214)."""
        self.software_power = int(power) & 0xFF
        self.registers[REG_POWER, 0] = self.hardware_power & 0xF0
        self.dirty[REG_POWER] = True

    def set_hardware_power(self, power: int):
        """0..255, upper 4 bits drive the PA bias DAC (h:216-222)."""
        self.hardware_power = int(power) & 0xFF
        self.registers[REG_POWER, 0] = self.hardware_power & 0xF0
        self.dirty[REG_POWER] = True

    def set_pa_enabled(self, enabled: bool):
        self.registers[REG_POWER, 1] = \
            (self.registers[REG_POWER, 1] & 0xF7) | (0x08 if enabled else 0)
        self.dirty[REG_POWER] = True

    def set_tune(self, tune: bool):
        self.registers[REG_POWER, 1] = \
            (self.registers[REG_POWER, 1] & 0xEF) | (0x10 if tune else 0)
        self.dirty[REG_POWER] = True

    def set_ptt(self, ptt: bool):
        if ptt != self.transmit_mode:
            self.transmit_mode = bool(ptt)
            self.dirty[0] = True
            if ptt:
                with self._tx_lock:
                    self._tx_queue = np.zeros(0, np.complex64)

    # -- TX sample feed --------------------------------------------------
    def queue_tx_samples(self, iq: np.ndarray):
        with self._tx_lock:
            self._tx_queue = np.concatenate(
                [self._tx_queue, np.asarray(iq, np.complex64)])

    def tx_pending(self) -> int:
        with self._tx_lock:
            return len(self._tx_queue)

    # -- packet build/send -----------------------------------------------
    def _send_metis(self, endpoint: int, payload: bytes):
        self._send_seq += 1
        hdr = struct.pack(">BBBBI", 0xEF, 0xFE, 0x01, endpoint,
                          self._send_seq & 0xFFFFFFFF)
        try:
            self._sock.sendto(hdr + payload, self.address)
        except OSError as e:
            flog.warn("hl2 sendto failed: {}", repr(e))

    def _build_frame(self, out: np.ndarray, register: int, c0_extra: int):
        out[0] = out[1] = out[2] = SYNC
        out[3] = ((register << 1) | (1 if self.transmit_mode else 0)
                  | c0_extra) & 0xFF
        out[4:8] = self.registers[register]
        if self.dirty[register]:
            self.dirty[register] = False
        # TX IQ payload — 63 samples if available (h:498-525)
        with self._tx_lock:
            if len(self._tx_queue) >= SAMPLES_PER_FRAME:
                chunk = self._tx_queue[:SAMPLES_PER_FRAME]
                self._tx_queue = self._tx_queue[SAMPLES_PER_FRAME:]
            else:
                chunk = None
        if chunk is not None:
            self.clipped_tx_samples += encode_tx_samples(
                out[8:], chunk, self.software_power / 255.0)

    def _prepare_request(self, sequence: int) -> bytes:
        """Two HPSDR frames: frame 1 = reg 0, frame 2 = round-robin reg
        with the RQST readback handshake on the RX frequency
        (hl2_device.h:434-534)."""
        if sequence > 10 or sequence < 0:
            sequence = 1
        reg2 = SEND_REGISTERS[sequence]
        rqst = 0
        if not self.transmit_mode:
            if self._rqst_phase == 0:
                if reg2 == REG_RX_FREQ and self.dirty[REG_RX_FREQ]:
                    rqst = 0x80
                    self._rqst_phase = 1
                    self._rqst_count = 0
            else:
                self._rqst_count += 1
                if self._rqst_count > 30:       # RQST timeout (h:466-469)
                    self.dirty[REG_RX_FREQ] = True
                    self._rqst_phase = 0
                elif reg2 == REG_RX_FREQ:
                    # unacked freq change pending: don't re-send the
                    # frequency register without the ack (h:473-476);
                    # substitute the TX-frequency slot as keepalive.
                    reg2 = REG_TX_FREQ
        payload = np.zeros(1024, np.uint8)
        self._build_frame(payload[0:FRAME_BYTES], 0, 0)
        self._build_frame(payload[FRAME_BYTES:], reg2, rqst)
        return payload.tobytes()

    def _metis_start_stop(self, command: int):
        pkt = bytearray(64)
        pkt[0], pkt[1], pkt[2], pkt[3] = 0xEF, 0xFE, 0x04, command
        try:
            self._sock.sendto(bytes(pkt), self.address)
        except OSError as e:
            flog.warn("hl2 start/stop send failed: {}", repr(e))

    # -- receive path ------------------------------------------------------
    def _process_control(self, c: np.ndarray):
        """Telemetry/ACK decode (hl2_device.h:569-636)."""
        if c[0] & 0x80:                       # ACK readback
            raddr = (int(c[0]) >> 1) & 0x1F
            self._rqst_phase = 0
            self._rqst_count = 0
            if raddr == REG_RX_FREQ:
                self.confirmed_frequency = (int(c[1]) << 24) \
                    | (int(c[2]) << 16) | (int(c[3]) << 8) | int(c[4])
            return
        group = (int(c[0]) >> 3) & 0x1F
        if group == 0:
            self.adc_overload = bool(c[1] & 0x01)
            if self.transmit_mode:
                recovery = (int(c[3]) & 0xC0) >> 6
                if recovery == 3:
                    self.fill_level = 10000.0   # overflow
                elif recovery == 2:
                    self.fill_level = -1.0      # underflow
                else:
                    self.fill_level = (int(c[3]) & 0x3F) * 16.0 / 48.0
                    self._fill_update = time.monotonic()
        elif group == 1:
            adc = (int(c[1]) << 8) | int(c[2])
            t = (3.26 * (adc / 4096.0) - 0.5) / 0.01
            self.temperature = 0.7 * t + 0.3 * self.temperature
            self.alex_forward_power = (int(c[3]) << 8) | int(c[4])
        elif group == 2:
            self.alex_reverse_power = (int(c[1]) << 8) | int(c[2])
        elif group == 28:
            self.swr = int(c[1]) / 10.0
            return
        self._update_swr()

    def _update_swr(self):
        """Exact reference SWR math (hl2_device.h:241-285)."""
        fwd_power = self.alex_forward_power
        rev_power = self.alex_reverse_power
        if rev_power > fwd_power:
            fwd_power, rev_power = rev_power, fwd_power
        fwd_power -= 6                          # fwd_cal_offset
        v1 = (fwd_power / 4095.0) * 3.3
        self.fwd = (v1 * v1) / 1.4
        self.rev = 0.0
        if fwd_power != 0:
            v1 = (rev_power / 4095.0) * 3.3
            self.rev = (v1 * v1) / 1.4
        if self.fwd < 0.05:
            self.swr = 1.0
        else:
            ratio = np.sqrt(self.rev / self.fwd) if self.fwd > 0 else 0.0
            this_swr = (1 + ratio) / (1 - ratio) if ratio < 1 else 1.0
            if this_swr < 0:
                this_swr = 1.0
            if not np.isfinite(self.swr):
                self.swr = 1.0
            self.swr = 0.7 * this_swr + 0.3 * self.swr

    def _recv_loop(self):
        while self.running:
            try:
                raw, _addr = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(raw) < 8 or raw[0] != 0xEF or raw[1] != 0xFE:
                continue
            if raw[2] == 0x01 and raw[3] == 6 and len(raw) >= 1032:
                buf = np.frombuffer(raw, np.uint8)
                for off in (8, 8 + FRAME_BYTES):
                    control, iq, _mic = decode_rx_frame(
                        buf[off:off + FRAME_BYTES], self.receivers)
                    if control is None:
                        continue
                    self._process_control(control)
                    if iq.shape[1] and self.handler is not None:
                        self.handler(iq[0])
            elif raw[2] == 28 and raw[3] == 6:
                # HL2-proxy extension: packed control registers (h:638-654)
                body = np.frombuffer(raw[8:], np.uint8)
                if len(body) >= 3 and body[0] == SYNC and body[1] == SYNC \
                        and body[2] == SYNC:
                    scan = 3
                    for _ in range(10):
                        if scan + 5 > len(body) or body[scan] == 0xFF:
                            break
                        self._process_control(body[scan:scan + 5])
                        scan += 5

    # -- pacer (hl2_device.h:854-937) -------------------------------------
    def _pacer_loop(self):
        entries = 0
        while self.running:
            time.sleep(self.pacer_interval)
            entries += 1
            now = time.monotonic()
            if not self.transmit_mode:
                if now - self._last_send < 0.003:
                    continue
            else:
                if entries % 2 == 1:
                    continue
                if self.fill_level >= 1:
                    if now - self._fill_update > 0.005:
                        # fill level stopped updating: average by time
                        if now - self._last_send < 0.003:
                            continue
                    if self.fill_level > 15:
                        continue                # device fifo full
            payload = self._prepare_request(self._second_index)
            self._second_index += 1
            if self._second_index > 10:
                self._second_index = 1
            self._last_send = time.monotonic()
            self._send_metis(0x02, payload)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self.running:
            return
        self.running = True
        # metis_restart (h:800-809): push registers, then start streaming
        self._send_metis(0x02, self._prepare_request(2))
        self._send_metis(0x02, self._prepare_request(1))
        self._metis_start_stop(1)
        self._threads = [
            threading.Thread(target=self._recv_loop, daemon=True,
                             name="hl2-recv"),
            threading.Thread(target=self._pacer_loop, daemon=True,
                             name="hl2-pacer"),
        ]
        for t in self._threads:
            t.start()

    def stop(self):
        if not self.running:
            return
        self.running = False
        for t in self._threads:
            t.join(timeout=2.0)
        self._metis_start_stop(0)
        try:
            self._sock.close()
        except OSError:
            pass
        self.fill_level = 0.0


# ---------------------------------------------------------------------------
# source-manager wrapper + Transmitter
# ---------------------------------------------------------------------------

class HL2Source(_QueueSource, Transmitter):
    """Hermes Lite 2 as a SourceManager source and app Transmitter.

    reference: main.cpp:40-120 (module registers "Hermes Lite 2" with the
    SourceManager and installs itself as ``sigpath::transmitter``).
    """

    name = "Hermes Lite 2"

    def __init__(self, host: str = "localhost", port: int = DATA_PORT,
                 samplerate: int = 384_000, adc_gain: int = 0,
                 auto_band_relays: bool = True,
                 pacer_interval: float = 0.001):
        _QueueSource.__init__(self, float(samplerate))
        self._acc: List[np.ndarray] = []
        self._acc_n = 0
        self._block = max(int(samplerate) // 200, SAMPLES_PER_FRAME)
        self.device = HL2Device((host, port), self._rx_frame,
                                rx_sample_rate=int(samplerate),
                                pacer_interval=pacer_interval)
        self.device.set_adc_gain(adc_gain)
        self.auto_band_relays = auto_band_relays
        self._ptt = False
        self._tx_gain = 255
        self.device.start()

    # -- source interface -------------------------------------------------
    def _rx_frame(self, iq: np.ndarray):
        """A frame's 63 samples into SR/200-sample blocks (the network
        sources' block) before they are queued: the queue's 256 items
        then hold 1.28 s, where a frame an item held 42 ms at 384 kS/s
        and a pump block's pause overran it.  The samples are the JAX
        source's, in the same order."""
        self._acc.append(iq)
        self._acc_n += len(iq)
        if self._acc_n >= self._block:
            self._push(np.concatenate(self._acc))
            self._acc, self._acc_n = [], 0

    def tune(self, freq_hz: float):
        self.device.set_frequency(int(round(freq_hz)))
        if self.auto_band_relays:
            self.device.set_seven_relays(relays_for_frequency(freq_hz))

    def close(self):
        self.device.stop()
        super().close()

    # -- Transmitter interface (models/trx.py; reference trx.h:14-47) -----
    def set_ptt(self, ptt: bool):
        self._ptt = bool(ptt)
        self.device.set_ptt(self._ptt)

    def get_ptt(self) -> bool:
        return self._ptt

    def set_tx_frequency(self, freq: float):
        self.device.set_tx_frequency(int(round(freq)))

    def set_tx_gain(self, gain: float):
        """0..1 → software power 0..255 (main.cpp setTransmitSoftwareGain)."""
        self._tx_gain = int(round(max(0.0, min(1.0, gain)) * 255))
        self.device.set_software_power(self._tx_gain)

    def set_tx_hardware_gain(self, gain255: int):
        self.device.set_hardware_power(gain255)

    def set_pa_enabled(self, enabled: bool):
        self.device.set_pa_enabled(enabled)

    def send_iq(self, iq: np.ndarray):
        self.device.queue_tx_samples(iq)

    def get_forward_power(self) -> float:
        return float(self.device.fwd)

    def get_reflected_power(self) -> float:
        return float(self.device.rev)

    def get_swr(self) -> float:
        return float(self.device.swr)

    @property
    def temperature(self) -> float:
        return float(self.device.temperature)


def register(source_manager, **defaults):
    """Register the HL2 provider (reference main.cpp:116)."""
    source_manager.register(
        HL2Source.name, lambda **cfg: HL2Source(**{**defaults, **cfg}))
