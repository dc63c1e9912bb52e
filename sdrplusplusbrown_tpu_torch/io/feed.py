"""Host→device IQ feed with transfer thinning (counterpart of
sdrplusplusbrown_tpu/io/feed.py).

The host↔device link (PCIe) is the narrowest pipe in a streaming
deployment — the role the reference's network link plays, so the same
compression ladder applies (reference: core/src/server.cpp:99-140 — raw
f32 | int8 PCM | lossy EFFT):

  * ``none``  — complex64 as-is (8 B/sample);
  * ``int8``  — the host quantizes re/im to int8 with one f32 scale per
    block (2 B/sample, 4× thinner); the device dequantizes;
  * ``efft``  — the host runs the EFFT masking (ops/efft.py) and ships
    the masked spectrum as int8 (dense frames); the device re-expands the
    ∜ companding and inverse-FFTs (ops/efft_device.efft_decompress).

The host side (the quantisation, the EFFT masking and the byte
accounting) is the JAX feed's, unchanged; the dequantisation and the
EFFT re-expansion run on the feed's device.  The device→host direction
(baseband thinned on the device before its copy) is
ops/efft_device.EFFTCompressorDevice.

``stats()`` reports the bytes moved against the raw bytes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.efft import EFFTCompressor
from ..ops.efft_device import efft_decompress
from ..runtime.block import entry_device


def _quantize(inter: np.ndarray):
    """float32 re/im pairs → (int8 [2T], scale): the JAX feed's rounding."""
    scale = float(np.max(np.abs(inter))) or 1.0
    q = np.clip(np.round(inter / scale * 127.0), -127, 127).astype(np.int8)
    return q, scale


def _interleave(z: np.ndarray) -> np.ndarray:
    inter = np.empty(z.size * 2, np.float32)
    inter[0::2] = z.real
    inter[1::2] = z.imag
    return inter


class DeviceFeed:
    """Feed host IQ blocks to the device through a compression toggle.
    The device is CUDA unless the caller asks for the CPU."""

    def __init__(self, mode: str = "none",
                 samplerate: Optional[float] = None,
                 loss_rate: float = 4.0, device="cuda"):
        assert mode in ("none", "int8", "efft"), mode
        self.device = entry_device(device)
        self.mode = mode
        self.raw_bytes = 0
        self.moved_bytes = 0
        self._efft: Optional[EFFTCompressor] = None
        if mode == "efft":
            assert samplerate, "efft mode needs the samplerate"
            self._efft = EFFTCompressor(samplerate, loss_rate=loss_rate)

    def _dequant(self, q: np.ndarray, scale: float) -> torch.Tensor:
        """int8 re/im pairs → complex64 on the device: q · (scale / 127)
        in float32, as the JAX feed computes it."""
        f = torch.from_numpy(q).to(self.device).float() \
            * float(np.float32(scale) / np.float32(127.0))
        return torch.complex(f[0::2], f[1::2])

    def push(self, iq: np.ndarray) -> Optional[torch.Tensor]:
        """→ complex64 tensor on the device (or None while the EFFT queue
        primes).  The accounting covers what crossed the host→device
        boundary."""
        iq = np.asarray(iq, np.complex64)
        self.raw_bytes += iq.nbytes
        if self.mode == "none":
            self.moved_bytes += iq.nbytes
            return torch.from_numpy(iq).to(self.device)
        if self.mode == "int8":
            q, scale = _quantize(_interleave(iq))
            self.moved_bytes += q.nbytes + 4
            return self._dequant(q, scale)
        # efft: host-side masking, device-side expansion + iFFT
        frames = self._efft.process(iq)
        if not frames:
            return None
        q, scale = _quantize(_interleave(np.concatenate(frames)))
        # the wire/entropy layer sends zero runs for free; count the
        # nonzero payload + a byte of run-length per zero run as moved
        nz = int(np.count_nonzero(q))
        runs = int(np.count_nonzero(np.diff((q == 0).astype(np.int8))))
        self.moved_bytes += nz + runs + 8
        return efft_decompress(self._dequant(q, scale).reshape(
            -1, self._efft.fft_size))

    def stats(self) -> dict:
        return {"mode": self.mode, "raw_bytes": self.raw_bytes,
                "moved_bytes": self.moved_bytes,
                "ratio": (self.moved_bytes / self.raw_bytes)
                if self.raw_bytes else 0.0}
