"""Block protocol (counterpart of sdrplusplusbrown_tpu/runtime/block.py).

A DSP stage is a function over a fixed-size block of samples with explicit
carried state:

    y, new_state = block.apply(params, state, x)

  * ``x``/``y`` are tensors shaped ``[..., T]``; leading axes are batched
    VFO channels.  A plain block follows its input's device; the entry
    points (``Radio``, the VFO banks, ``SpectrumPath``) own a device of
    their own (``device=``, CUDA by default), create their params and
    state there and move only the input to it.
  * ``state`` is a dict/list tree of tensors (filter tails, NCO phase) with
    the JAX package's keys, shapes and dtypes, so checkpoints and parity
    tests convert one-to-one (``convert.py``).
  * ``params`` holds the runtime knobs (frequency offsets); structural
    settings (rates, tap counts) are constructor arguments.

Each block declares ``ratio`` (output/input length, a Fraction) and
``in_multiple`` (the input granularity it needs); ``Chain`` combines them so
a whole pipeline has one exact input granularity.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Sequence, Tuple

import numpy as np
import torch


class Block:
    """Base class for stateful stream-processing blocks."""

    #: output_length / input_length (exact rational).
    ratio: Fraction = Fraction(1, 1)
    #: input block length must be a multiple of this.
    in_multiple: int = 1

    def init_state(self, batch_shape: Tuple[int, ...] = ()) -> Any:
        return None

    def init_params(self) -> Any:
        """Default runtime params (empty for most blocks)."""
        return None

    def apply(self, params: Any, state: Any, x):
        raise NotImplementedError


def entry_device(device) -> torch.device:
    """The device of an entry point: CUDA unless the caller asks for the
    CPU.  Raises, rather than running on the host, when it is a CUDA
    device and this machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless it is built "
            "with device='cpu'")
    return dev


def to_device(tree, device: torch.device):
    """A dict/list tree of tensors moved to ``device`` (at init and
    retune time only, never per step); a None leaf (a stateless block's
    state) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def device_const(owner, name: str, array, device) -> torch.Tensor:
    """The design-time numpy ``array`` (or what the function ``array``
    returns, called only when ``device`` has no copy yet) as a tensor on
    ``device``, made once and kept on ``owner`` under ``name`` (a copy
    from the host on every call would stall the stream)."""
    cache = owner.__dict__.setdefault("_dev_consts", {})
    key = (name, str(device))
    if key not in cache:
        a = array() if callable(array) else array
        cache[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return cache[key]


def lcm_fraction(a: Fraction, b: Fraction) -> Fraction:
    """Least common multiple of two positive rationals."""
    return Fraction(math.lcm(a.numerator, b.numerator),
                    math.gcd(a.denominator, b.denominator))


class Chain(Block):
    """Ordered composition of named blocks."""

    def __init__(self, blocks: Sequence[Tuple[str, Block]]):
        self.named_blocks = list(blocks)
        ratio = Fraction(1, 1)
        need = Fraction(1, 1)
        for _, blk in self.named_blocks:
            # this block sees L·ratio samples, which must be a multiple of
            # blk.in_multiple  ⇒  L a multiple of in_multiple / ratio
            need = lcm_fraction(need, Fraction(blk.in_multiple) / ratio)
            ratio *= blk.ratio
        self.ratio = ratio
        # L integer and a multiple of need = p/q (lowest terms) ⇔ p | L
        self.in_multiple = need.numerator

    def init_state(self, batch_shape=()):
        return {name: blk.init_state(batch_shape)
                for name, blk in self.named_blocks}

    def apply(self, params, state, x):
        params = params or {}
        new_state = dict(state)
        for name, blk in self.named_blocks:
            x, new_state[name] = blk.apply(params.get(name), state[name], x)
        return x, new_state
