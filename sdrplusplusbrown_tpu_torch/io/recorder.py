"""Recorder: stream audio or baseband IQ to a WAV file (a copy of
sdrplusplusbrown_tpu/io/recorder.py; numpy only).

reference: misc_modules/recorder — records demod audio (stereo 16-bit) or
raw baseband (stereo float/int16 IQ) with the capture-timestamp filename
convention.
"""

from __future__ import annotations

import struct
from datetime import datetime
from typing import Optional

import numpy as np


class WavRecorder:
    """Incremental WAV writer (16-bit PCM or float32)."""

    def __init__(self, path: str, samplerate: float, channels: int = 2,
                 bits: int = 16):
        self.path = path
        self.samplerate = int(round(samplerate))
        self.channels = channels
        self.bits = bits
        self._fmt = 1 if bits == 16 else 3
        self._f = open(path, "wb")
        self._data_bytes = 0
        self._write_header()

    def _write_header(self):
        block = self.channels * self.bits // 8
        hdr = b"RIFF" + struct.pack("<I", 36 + self._data_bytes) + b"WAVE"
        hdr += b"fmt " + struct.pack(
            "<IHHIIHH", 16, self._fmt, self.channels, self.samplerate,
            self.samplerate * block, block, self.bits)
        hdr += b"data" + struct.pack("<I", self._data_bytes)
        self._f.seek(0)
        self._f.write(hdr)

    def write(self, samples: np.ndarray):
        """samples: [C, T] float32, [T] mono, or complex IQ [T]."""
        if np.iscomplexobj(samples):
            inter = np.stack([np.real(samples), np.imag(samples)], axis=-1)
        elif samples.ndim == 2:
            inter = np.moveaxis(samples, 0, -1)
        else:
            inter = samples[:, None]
        flat = inter.reshape(-1).astype(np.float32)
        if self.bits == 16:
            raw = np.clip(flat * 32768.0, -32768, 32767).astype("<i2")
        else:
            raw = flat.astype("<f4")
        self._f.seek(0, 2)
        self._f.write(raw.tobytes())
        self._data_bytes += raw.nbytes

    def close(self):
        self._write_header()
        self._f.close()

    @staticmethod
    def capture_name(prefix: str, center_hz: float,
                     when: Optional[datetime] = None) -> str:
        when = when or datetime.now()
        return (f"{prefix}_{int(center_hz)}Hz_"
                f"{when:%H-%M-%S}_{when:%d-%m-%Y}.wav")
