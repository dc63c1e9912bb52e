"""Inter-kernel handoff storage dtype (counterpart of
sdrplusplusbrown_tpu/ops/precision.py).

The front-end kernel, the WFM demod kernel and the audio polyphase hand IF
and MPX planes to each other through device memory.  Those planes may be
stored as bfloat16 (the default, as in the JAX package) or float32; all
arithmetic stays float32 — bf16 is storage only, upcast on load.  The same
dtype governs where the JAX package rounds tap matrices and carried state
tails, and the port rounds at the same places.
"""

from __future__ import annotations

import torch

_HANDOFF = ["bf16"]

_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def set_handoff_dtype(name: str) -> None:
    if name not in _DTYPES:
        raise ValueError(f"handoff dtype {name!r} not in {set(_DTYPES)}")
    _HANDOFF[0] = name


def get_handoff_dtype() -> torch.dtype:
    """Current inter-kernel plane dtype (a torch dtype)."""
    return _DTYPES[_HANDOFF[0]]


def get_handoff_name() -> str:
    return _HANDOFF[0]


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` storage and read back as float32 (complex
    tensors round their real and imaginary parts)."""
    if dtype == torch.float32:
        return x
    if x.is_complex():
        return torch.complex(x.real.to(dtype).float(),
                             x.imag.to(dtype).float())
    return x.to(dtype).float()
