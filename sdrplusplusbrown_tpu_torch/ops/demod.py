"""FM quadrature discriminator (counterpart of the Quadrature block of
sdrplusplusbrown_tpu/ops/demod.py; reference demod/quadrature.h:39-46).

    out[n] = angle(x[n]·conj(x[n−1])) / deviation

with the previous sample as one-sample state.  The WFM main path runs it
inside kernel K2 (ops/wfm_kernel.py); this is the plain block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block


_TINY = float(np.finfo(np.float32).tiny)


def quad_planes(er, ei, erp, eip, inv_deviation: float) -> torch.Tensor:
    """Discriminator on re/im planes given the one-sample-lagged planes;
    a zero product (e.g. a closed squelch gate) gives exact silence.
    Subnormal products count as zero, as on the TPU and XLA:CPU (which
    flush them): the cold-start IF ramps through subnormals, whose angle
    is noise."""
    re = er * erp + ei * eip
    im = ei * erp - er * eip
    re = torch.where(re.abs() < _TINY, torch.zeros_like(re), re)
    im = torch.where(im.abs() < _TINY, torch.zeros_like(im), im)
    y = torch.atan2(im, re)
    return torch.where((re == 0) & (im == 0), torch.zeros_like(y), y) \
        * inv_deviation


class Quadrature(Block):
    def __init__(self, deviation_hz: float, samplerate: float):
        self.inv_deviation = float(
            1.0 / (2.0 * np.pi * deviation_hz / samplerate))
        self.samplerate = samplerate

    def init_state(self, batch_shape=()):
        # reference phase starts at 0 ⇒ carried phasor 1+0j
        return torch.ones(batch_shape + (1,), dtype=torch.complex64)

    def apply(self, params, state, x):
        ext = torch.cat([state.to(x.device), x], dim=-1)
        y = quad_planes(ext.real[..., 1:], ext.imag[..., 1:],
                        ext.real[..., :-1], ext.imag[..., :-1],
                        self.inv_deviation)
        return y, x[..., -1:]

    def apply_planes(self, state, xr, xi):
        state = state.to(xr.device)
        er = torch.cat([state.real, xr], dim=-1)
        ei = torch.cat([state.imag, xi], dim=-1)
        y = quad_planes(er[..., 1:], ei[..., 1:], er[..., :-1], ei[..., :-1],
                        self.inv_deviation)
        return y, torch.complex(xr[..., -1:], xi[..., -1:])
