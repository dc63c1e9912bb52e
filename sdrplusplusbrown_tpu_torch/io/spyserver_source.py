"""SpyServer protocol client source (a copy of
sdrplusplusbrown_tpu/io/spyserver_source.py; host code, the same bytes on
the wire).

reference: source_modules/spyserver_source/src/{spyserver_protocol.h,
spyserver_client.cpp,main.cpp} — a TCP client of Airspy's SpyServer:

* handshake: ``CMD_HELLO`` carrying the protocol version and app name
  (spyserver_client.cpp:79-90); commands are ``{u32 type, u32 body}``
  headers + body (:71-77), settings are ``{u32 setting, u32 value}``
  pairs via ``CMD_SET_SETTING`` (:92-97).
* server messages: 20-byte header ``{ProtocolID, MessageType,
  StreamType, SequenceNumber, BodySize}`` (spyserver_protocol.h:107-113);
  the low 16 bits of MessageType select the type, the high 16 bits carry
  a gain in dB applied as ``10^(flags/20)`` (spyserver_client.cpp:122-158).
* IQ payloads: u8 ``(x-128)/(gain·128)``, int16 ``x/(32768·gain)`` or
  float32 ``x·gain`` interleaved pairs (:135-158).
* start sequence (main.cpp:131-137): IQ format, IQ decimation
  (srId + MinimumIQDecimation), IQ frequency, streaming mode IQ_ONLY,
  gain, digital gain, then STREAMING_ENABLED=1; the effective rate is
  ``MaximumSampleRate / 2^decimation`` (main.cpp:270-281).
"""

from __future__ import annotations

import struct
import threading
from typing import Optional

import numpy as np

from .network_source import _QueueSource
from ..utils.flog import flog

PROTOCOL_VERSION = (2 << 24) | (0 << 16) | 1700   # spyserver_protocol.h:16

CMD_HELLO = 0
CMD_SET_SETTING = 2
CMD_PING = 3

SETTING_STREAMING_MODE = 0
SETTING_STREAMING_ENABLED = 1
SETTING_GAIN = 2
SETTING_IQ_FORMAT = 100
SETTING_IQ_FREQUENCY = 101
SETTING_IQ_DECIMATION = 102
SETTING_IQ_DIGITAL_GAIN = 103

STREAM_MODE_IQ_ONLY = 1

FORMAT_UINT8 = 1
FORMAT_INT16 = 2
FORMAT_FLOAT = 4

MSG_DEVICE_INFO = 0
MSG_CLIENT_SYNC = 1
MSG_PONG = 2
MSG_UINT8_IQ = 100
MSG_INT16_IQ = 101
MSG_FLOAT_IQ = 103

_DEVICE_INFO_FIELDS = (
    "DeviceType", "DeviceSerial", "MaximumSampleRate", "MaximumBandwidth",
    "DecimationStageCount", "GainStageCount", "MaximumGainIndex",
    "MinimumFrequency", "MaximumFrequency", "Resolution",
    "MinimumIQDecimation", "ForcedIQFormat")


class SpyServerSource(_QueueSource):
    """Connect, handshake, configure and stream IQ from a SpyServer."""

    def __init__(self, host: str = "localhost", port: int = 5555,
                 srate_index: int = 0, iq_format: int = FORMAT_INT16,
                 gain: int = 0, app_name: str = "SDR++TPU",
                 devinfo_timeout: float = 3.0):
        import socket
        super().__init__(0.0)
        self.sock = socket.create_connection((host, port), timeout=10)
        self.device_info: Optional[dict] = None
        self.client_sync: Optional[dict] = None
        self.iq_format = int(iq_format)
        self.gain = int(gain)
        self.srate_index = int(srate_index)
        self._devinfo_evt = threading.Event()
        self._send_command(CMD_HELLO, struct.pack(
            "<I", PROTOCOL_VERSION) + app_name.encode())
        self._start_rx()
        # main.cpp:248 waits 3 s for device info before offering rates
        if not self._devinfo_evt.wait(devinfo_timeout):
            self.close()
            raise TimeoutError("no device info from SpyServer")
        di = self.device_info
        decim = self.srate_index + di["MinimumIQDecimation"]
        self.samplerate = di["MaximumSampleRate"] / (1 << decim)
        self._decimation = decim

    # -- control -------------------------------------------------------
    def _send_command(self, ctype: int, body: bytes):
        self.sock.sendall(struct.pack("<II", ctype, len(body)) + body)

    def set_setting(self, setting: int, value: int):
        self._send_command(CMD_SET_SETTING,
                           struct.pack("<II", setting, int(value)))

    def start_stream(self, freq_hz: float):
        """The reference start sequence (main.cpp:131-137)."""
        di = self.device_info
        self.set_setting(SETTING_IQ_FORMAT, self.iq_format)
        self.set_setting(SETTING_IQ_DECIMATION, self._decimation)
        self.set_setting(SETTING_IQ_FREQUENCY, int(round(freq_hz)))
        self.set_setting(SETTING_STREAMING_MODE, STREAM_MODE_IQ_ONLY)
        self.set_setting(SETTING_GAIN, self.gain)
        self.set_setting(SETTING_IQ_DIGITAL_GAIN,
                         self._digital_gain(di, self.gain,
                                            self._decimation))
        self.set_setting(SETTING_STREAMING_ENABLED, 1)

    def stop_stream(self):
        self.set_setting(SETTING_STREAMING_ENABLED, 0)

    def tune(self, freq_hz: float):
        self.set_setting(SETTING_IQ_FREQUENCY, int(round(freq_hz)))

    @staticmethod
    def _digital_gain(di: dict, gain: int, decim: int) -> int:
        """spyserver_client.cpp:47-60 computeDigitalGain."""
        dtype = di["DeviceType"]
        if dtype == 1:      # AIRSPY_ONE
            return int((di["MaximumGainIndex"] - gain) + decim * 3.01)
        if dtype in (2, 3):  # AIRSPY_HF / RTLSDR
            return int(decim * 3.01)
        return -1

    # -- data ------------------------------------------------------------
    def _rx_loop(self):
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(20)
                proto_id, mtype_raw, stype, seq, body_size = \
                    struct.unpack("<IIIII", hdr)
                body = self._recv_exact(body_size) if body_size else b""
                mtype = mtype_raw & 0xFFFF
                gain_db = (mtype_raw >> 16) & 0xFFFF
                gain = 10.0 ** (gain_db / 20.0)
                if mtype == MSG_DEVICE_INFO:
                    vals = struct.unpack(f"<{len(_DEVICE_INFO_FIELDS)}I",
                                         body[:4 * len(_DEVICE_INFO_FIELDS)])
                    self.device_info = dict(zip(_DEVICE_INFO_FIELDS, vals))
                    self._devinfo_evt.set()
                elif mtype == MSG_CLIENT_SYNC:
                    names = ("CanControl", "Gain", "DeviceCenterFrequency",
                             "IQCenterFrequency", "FFTCenterFrequency",
                             "MinimumIQCenterFrequency",
                             "MaximumIQCenterFrequency")
                    vals = struct.unpack(f"<{len(names)}I",
                                         body[:4 * len(names)])
                    self.client_sync = dict(zip(names, vals))
                elif mtype == MSG_UINT8_IQ:
                    flat = np.frombuffer(body, np.uint8).astype(np.float32)
                    f = (flat - 128.0) / np.float32(gain * 128.0)
                    self._push((f[0::2] + 1j * f[1::2]).astype(np.complex64))
                elif mtype == MSG_INT16_IQ:
                    flat = np.frombuffer(body, "<i2").astype(np.float32)
                    f = flat / np.float32(32768.0 * gain)
                    self._push((f[0::2] + 1j * f[1::2]).astype(np.complex64))
                elif mtype == MSG_FLOAT_IQ:
                    flat = np.frombuffer(body, "<f4") * np.float32(gain)
                    self._push((flat[0::2] + 1j * flat[1::2])
                               .astype(np.complex64))
                # PONG / unknown types are ignored
        except (OSError, ConnectionError) as e:
            if not self._stop.is_set():
                flog.warn("spyserver rx ended: {}", repr(e))
        finally:
            self._devinfo_evt.set()
            try:
                self._q.put_nowait(None)
            except Exception:
                pass

    def _recv_exact(self, n: int) -> bytes:
        raw = b""
        while len(raw) < n:
            part = self.sock.recv(n - len(raw))
            if not part:
                raise ConnectionError("peer closed")
            raw += part
        return raw

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        super().close()
