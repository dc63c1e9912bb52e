"""File source: WAV IQ playback in fixed-size blocks (counterpart of
sdrplusplusbrown_tpu/io/file_source.py, reading through numpy only; the
JAX package's optional native WAV reader is not ported).

reference: source_modules/file_source/src/main.cpp — reads the capture in
SR/200-sample (≈5 ms) blocks, converts int16→float, optionally loops.
Here the source is a host-side iterator of numpy blocks; real-time pacing
(the reference sleeps to simulate the antenna) is optional.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from .wav import read_wav_iq, parse_capture_filename


class FileSource:
    def __init__(self, path: str, block_len: Optional[int] = None,
                 loop: bool = False, realtime: bool = False):
        self.path = path
        self.data, self.samplerate = read_wav_iq(path)
        self.center_freq, self.capture_time = parse_capture_filename(path)
        # reference default block: SR/200 (main.cpp:399)
        self.block_len = int(block_len or round(self.samplerate / 200))
        self.loop = loop
        self.realtime = realtime

    def __len__(self):
        return len(self.data)

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield fixed-size blocks (zero-padded at the tail)."""
        B = self.block_len
        t0 = time.monotonic()
        emitted = 0
        while True:
            for i in range(0, len(self.data), B):
                blk = self.data[i:i + B]
                if len(blk) < B:
                    blk = np.pad(blk, (0, B - len(blk)))
                if self.realtime:
                    due = t0 + emitted / self.samplerate
                    now = time.monotonic()
                    if due > now:
                        time.sleep(due - now)
                emitted += B
                yield blk
            if not self.loop:
                return
