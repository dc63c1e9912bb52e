"""Digital symbol primitives: binary slicer, differential codec,
Manchester codec (counterpart of sdrplusplusbrown_tpu/ops/digital.py;
reference core/src/dsp/digital/*.h).

``DifferentialDecoder`` is a block on tensors (elementwise, on whatever
device its input lies); the slicer, the encoder and the Manchester codec
are host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block


def binary_slice(x):
    """float → bit (reference digital/binary_slicer.h: in > 0)."""
    return (np.asarray(x) > 0.0).astype(np.uint8)


def valid_hard_bits(sym: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """The sliced bits (sym > 0) of a clock recovery's valid symbols as a
    host uint8 array: sliced and marked on the symbols' device, then one
    copy to the host (no count read back first, as ``sym[valid]`` on the
    card would)."""
    b = torch.where(valid, (sym > 0.0).to(torch.uint8),
                    torch.full_like(valid, 2, dtype=torch.uint8))
    b = b.cpu().numpy()
    return b[b != 2]


def valid_dibits(dibit: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """A demod's dibits at its valid symbols as a host int32 array: marked
    on the dibits' device, then one copy to the host (as
    ``valid_hard_bits``)."""
    d = torch.where(valid, dibit.to(torch.int32),
                    torch.full_like(dibit, -1, dtype=torch.int32))
    d = d.cpu().numpy()
    return d[d >= 0]


class DifferentialDecoder(Block):
    """out[n] = (in[n] − in[n−1]) mod M (reference
    digital/differential_decoder.h; M = 2 → XOR for bits)."""

    def __init__(self, modulus: int = 2):
        self.modulus = int(modulus)

    def init_state(self, batch_shape=()):
        return torch.zeros(batch_shape + (1,), dtype=torch.int32)

    def apply(self, params, state, x):
        """x [..., T] integers → (uint8 [..., T], the last input [..., 1])."""
        x = torch.as_tensor(x).to(torch.int32)
        ext = torch.cat([state.to(x.device, torch.int32), x], dim=-1)
        out = torch.remainder(ext[..., 1:] - ext[..., :-1], self.modulus)
        return out.to(torch.uint8), ext[..., -1:]


class DifferentialEncoder(Block):
    """out[n] = (in[n] + out[n−1]) mod M — host-side helper for TX/tests."""

    def __init__(self, modulus: int = 2):
        self.modulus = int(modulus)

    def encode(self, bits: np.ndarray, prev: int = 0) -> np.ndarray:
        out = np.zeros_like(bits)
        acc = prev
        for i, b in enumerate(bits):
            acc = (acc + int(b)) % self.modulus
            out[i] = acc
        return out


def manchester_encode(bits: np.ndarray) -> np.ndarray:
    """bit → (bit, ~bit) symbol pair (reference digital/manchester.h)."""
    bits = np.asarray(bits, np.uint8)
    out = np.empty(2 * len(bits), np.uint8)
    out[0::2] = bits
    out[1::2] = 1 - bits
    return out


def manchester_decode(symbols: np.ndarray) -> np.ndarray:
    symbols = np.asarray(symbols, np.uint8)
    return symbols[0::2]
