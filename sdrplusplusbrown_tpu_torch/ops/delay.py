"""Pure delay line (counterpart of sdrplusplusbrown_tpu/ops/delay.py;
reference core/src/dsp/math/delay.h — the d carried samples are state)."""

from __future__ import annotations

import torch

from ..runtime.block import Block


class Delay(Block):
    def __init__(self, delay: int):
        self.delay = int(delay)

    def init_state(self, batch_shape=(), dtype=torch.float32):
        return torch.zeros(batch_shape + (self.delay,), dtype=dtype)

    def apply(self, params, state, x):
        if self.delay == 0:
            return x, state
        ext = torch.cat([state.to(x.device, x.dtype), x], dim=-1)
        T = x.shape[-1]
        return ext[..., :T], ext[..., T:]
