"""The shared-VFO front end for chains K1 cannot take (counterpart of
sdrplusplusbrown_tpu/ops/plane_frontend.py:PlaneVFOPipeline and of the
per-stage route of sdrplusplusbrown_tpu/models/rx_vfo.py:SharedRxVFOBank).

Stage 0 (mix-down and first decimating FIR, twiddled) is kernel K11
(ops/fused_frontend.py); every later stage — the remaining decimators,
the L/M polyphase resampler and the bandwidth FIR — is one K8 launch
(ops/fir_kernel.py) on the [2C, m] float32 re/im rows: a real-tap stage
filters the re and im rows alike.  That is what the TPU's plane kernels
compute (``_plane_decim_kernel``, ``_plane_poly_kernel`` and
``_plane_poly_roll_kernel``; their head blocks, padded super-tiles and
rolled windows are Mosaic layout rules), and the per-stage route's
decimating FIRs and polyphase resampler on complex rows.  State stays in
the SharedRxVFOBank layout: the raw wideband tail and NCO phase, and a
complex64 [C, hist] tail per later stage.
"""

from __future__ import annotations

import torch

from .fir import device_taps
from .fir_kernel import fir_rows


class PlaneVFOPipeline:
    """The stages of a SharedRxVFOBank's chain; ``apply`` runs them."""

    def __init__(self, bank):
        self.bank = bank
        self.blocks = bank.stage_blocks()
        for blk in self.blocks:
            if getattr(blk, "_complex_taps", False):
                raise NotImplementedError("complex-tap front-end stage")

    @staticmethod
    def stage_taps(blk, device):
        """(kernel [I, kw] float32 on ``device``, I, D) of one stage."""
        if hasattr(blk, "interp"):
            return device_taps(blk, blk.kernel, device), blk.interp, blk.decim
        return device_taps(blk, blk.taps, device), 1, blk.decim

    def apply(self, params, state, x, raw: bool = True):
        """x: (xr, xi) float32 [T] planes of the shared wideband → (buf
        [2C, m_if] float32, re rows then im rows; new state): K11, then
        one K8 launch per later stage.  The buffer is float32 for the raw
        (K7) and the complex-IF consumers alike, so ``raw`` changes
        nothing here."""
        new_state = dict(state)
        y, new_state["fused"] = self.bank.fused.apply(params,
                                                      state["fused"], x)
        C = y.shape[0] // 2
        new_tails = []
        for blk, tc in zip(self.blocks, self.bank.stage_tails(state)):
            kern, I, D = self.stage_taps(blk, y.device)
            tail = torch.cat([tc.real, tc.imag]).contiguous()
            y, nt = fir_rows(y, tail, kern, I, D)
            new_tails.append(torch.complex(nt[:C], nt[C:]))
        self.bank.write_tails(new_state, new_tails)
        return y, new_state
