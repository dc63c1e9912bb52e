"""WAV (RIFF) IQ capture reading/writing (a copy of
sdrplusplusbrown_tpu/io/wav.py; numpy only).

reference: core/src/utils/wav.{h,cpp} and the file source's int16→float
conversion (source_modules/file_source/src/main.cpp:396-430,
volk_16i_s32f_convert_32f with scale 32768) plus its capture-timestamp
filename convention ``baseband_<centerHz>_<HH-MM-SS>_<dd-mm-yyyy>``
(file_source/src/main.cpp:471).

Supports PCM8/PCM16/PCM32 and IEEE float32, mono or stereo; stereo is
interpreted as interleaved I/Q.
"""

from __future__ import annotations

import re
import struct
from datetime import datetime
from typing import Optional, Tuple

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3


def _parse_chunks(buf: bytes):
    assert buf[:4] == b"RIFF" and buf[8:12] == b"WAVE", "not a WAV file"
    pos = 12
    chunks = {}
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        chunks[cid] = (pos + 8, size)
        pos += 8 + size + (size & 1)
    return chunks


def read_wav_iq(path: str) -> Tuple[np.ndarray, float]:
    """Read a WAV capture → (complex64 IQ (or float32 mono), samplerate)."""
    with open(path, "rb") as f:
        buf = f.read()
    chunks = _parse_chunks(buf)
    off, size = chunks[b"fmt "]
    fmt, channels, rate = struct.unpack("<HHI", buf[off:off + 8])
    bits = struct.unpack("<H", buf[off + 14:off + 16])[0]
    off, size = chunks[b"data"]
    raw = buf[off:off + size]

    if fmt == _FMT_PCM and bits == 16:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif fmt == _FMT_PCM and bits == 8:
        data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    elif fmt == _FMT_PCM and bits == 32:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif fmt == _FMT_FLOAT and bits == 32:
        data = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {fmt}/{bits}-bit")

    if channels == 2:
        data = data[:(len(data) // 2) * 2].reshape(-1, 2)
        return (data[:, 0] + 1j * data[:, 1]).astype(np.complex64), float(rate)
    return data, float(rate)


def write_wav(path: str, data: np.ndarray, samplerate: float,
              bits: int = 16):
    """Write mono float32 / stereo [2, T] / complex IQ data as WAV."""
    if np.iscomplexobj(data):
        inter = np.stack([np.real(data), np.imag(data)], axis=-1)
        channels = 2
    elif data.ndim == 2:
        inter = np.moveaxis(data, 0, -1)
        channels = data.shape[0]
    else:
        inter = data[:, None]
        channels = 1
    flat = inter.reshape(-1).astype(np.float32)
    if bits == 16:
        pcm = np.clip(flat * 32768.0, -32768, 32767).astype("<i2")
        fmt, bps = _FMT_PCM, 16
    elif bits == 32:
        pcm = flat.astype("<f4")
        fmt, bps = _FMT_FLOAT, 32
    else:
        raise ValueError(bits)
    payload = pcm.tobytes()
    rate = int(round(samplerate))
    block = channels * bps // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                 rate * block, block, bps)
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)


_CAPTURE_RE = re.compile(
    r"baseband_(\d+)(?:Hz)?_(\d{1,2})-(\d{2})-(\d{2})_(\d{1,2})-(\d{1,2})-(\d{4})")


def parse_capture_filename(name: str) -> Tuple[Optional[float],
                                               Optional[datetime]]:
    """(center_freq_hz, capture_time) from the reference's naming scheme
    ``baseband_14100000Hz_17-42-35_04-08-2023.wav``
    (reference file_source/src/main.cpp:454-480)."""
    m = _CAPTURE_RE.search(name)
    if not m:
        return None, None
    freq = float(m.group(1))
    hh, mm, ss, dd, mo, yyyy = (int(m.group(i)) for i in range(2, 8))
    try:
        ts = datetime(yyyy, mo, dd, hh, mm, ss)
    except ValueError:
        ts = None
    return freq, ts
