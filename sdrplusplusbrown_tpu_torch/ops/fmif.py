"""FM IF noise reduction (counterpart of sdrplusplusbrown_tpu/ops/fmif.py;
reference core/src/dsp/noise_reduction/fm_if.h:45-77): for every input
sample a Nuttall-windowed ``bins``-point FFT of the trailing window, only
the strongest bin kept, and the output the centre tap of its inverse:
out[n] = X_n[k*] · (−1)^{k*}.

All T sliding frames form one [T, bins] view; the DFT is one complex
matmul with the [bins, bins] DFT matrix (``torch.matmul``, as the JAX
package's XLA matmul), then an argmax and a select per row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block, device_const
from . import windows


class FMIF(Block):
    def __init__(self, bins: int = 32):
        self.bins = int(bins)
        # reference initBuffers: fftWin[i] = nuttall(i, bins-1)
        self.win = windows.fft_window("nuttall", self.bins).astype(np.float32)
        k = np.arange(self.bins)
        self.dft = np.exp(-2j * np.pi * np.outer(k, k) / self.bins) \
            .astype(np.complex64)
        self.sign = ((-1.0) ** k).astype(np.float32)

    def init_state(self, batch_shape=()):
        return torch.zeros(tuple(batch_shape) + (self.bins - 1,),
                           dtype=torch.complex64)

    def spectra(self, state, x):
        """(X [..., T, bins] of every sliding window, the new state)."""
        T = x.shape[-1]
        ext = torch.cat([state.to(x.device), x.to(torch.complex64)], dim=-1)
        frames = ext.unfold(-1, self.bins, 1) * device_const(
            self, "win", self.win, x.device)
        dft_t = device_const(self, "dft_t", self.dft.T, x.device)
        return torch.matmul(frames, dft_t), ext[..., T:]

    def apply(self, params, state, x):
        spec, new_state = self.spectra(state, x)
        sign = device_const(self, "sign", self.sign, x.device)
        k_star = spec.abs().argmax(-1, keepdim=True)
        y = torch.gather(spec, -1, k_star)[..., 0] * sign[k_star[..., 0]]
        return y, new_state
