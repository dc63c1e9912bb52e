"""De-emphasis (counterpart of the Deemphasis block of
sdrplusplusbrown_tpu/ops/recurrence.py).

Only the part the broadcast-FM path uses: the 1-pole de-emphasis
y[n] = α x[n] + (1-α) y[n-1] (reference filter/deephasis.h:14-101) in its
truncated-exponential FIR form, which ``Radio`` folds into the WFM audio
polyphase resampler (ops/resampler.py:fold_output_fir).  The standalone
recurrence is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block


class Deemphasis(Block):
    _FIR_KMAX = 512

    def __init__(self, tau: float, samplerate: float):
        dt = 1.0 / float(samplerate)
        self.alpha = float(dt / (tau + dt))
        self.tau = tau
        self.samplerate = samplerate
        r = 1.0 - self.alpha
        # horizon: r^K < 2^-27 (an lsb-level tail on fp32 audio)
        K = int(np.ceil(-27.0 * np.log(2.0) / np.log(r))) if r > 0.0 else 1
        self.fir_k = K if K <= self._FIR_KMAX else 0

    def impulse(self) -> np.ndarray:
        """Causal impulse response h[j] = α·(1−α)^j, length fir_k."""
        if not self.fir_k:
            raise ValueError("pole too slow for the FIR horizon")
        r = 1.0 - self.alpha
        return (self.alpha
                * np.power(np.float64(r), np.arange(self.fir_k)))

    def init_state(self, batch_shape=()):
        return torch.zeros(batch_shape, dtype=torch.float32)
