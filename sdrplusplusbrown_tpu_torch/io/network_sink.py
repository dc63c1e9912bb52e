"""Network audio sink: demod audio as int16 PCM over UDP or TCP (a copy of
sdrplusplusbrown_tpu/io/network_sink.py; host code, the same bytes on the
wire).

reference: sink_modules/network_sink/src/main.cpp — converts each audio
block to int16 (scale 32768, :246,256), interleaving L/R when stereo
(:251-258), and writes it to the configured host:port over the selected
protocol.  Packets are sized by the packer block (500-sample default in
the reference UI); here each ``write()`` call emits one send per packer
block so UDP datagrams stay bounded.
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np

from ..utils.flog import flog


class NetworkSink:
    def __init__(self, host: str = "localhost", port: int = 7355,
                 protocol: str = "udp", stereo: bool = False,
                 packer_block: int = 500):
        self.host = host
        self.port = int(port)
        self.protocol = protocol
        self.stereo = bool(stereo)
        self.packer_block = int(packer_block)
        self.samples_sent = 0
        self._pend: Optional[np.ndarray] = None
        if protocol == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.connect((host, self.port))
        elif protocol == "tcp":
            self.sock = socket.create_connection((host, self.port),
                                                 timeout=10)
        else:
            raise ValueError(f"unknown protocol {protocol!r}")

    def write(self, audio: np.ndarray):
        """audio: [T] mono or [2, T] stereo float."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            if self.stereo:
                frames = audio.T.reshape(-1, 2)     # L/R interleave
            else:
                frames = audio.mean(axis=0)[:, None]  # stereo→mono mixdown
        else:
            if self.stereo:
                frames = np.repeat(audio[:, None], 2, axis=1)
            else:
                frames = audio[:, None]
        if self._pend is not None and len(self._pend):
            frames = np.concatenate([self._pend, frames], axis=0)
        B = self.packer_block
        n_full = (len(frames) // B) * B
        self._pend = frames[n_full:]
        try:
            for i in range(0, n_full, B):
                pcm = np.clip(frames[i:i + B] * 32768.0,
                              -32768, 32767).astype("<i2")
                self.sock.sendall(pcm.tobytes())
                self.samples_sent += B
        except OSError as e:
            flog.warn("network sink send failed: {}", repr(e))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
