"""Block protocol (counterpart of sdrplusplusbrown_tpu/runtime/block.py).

A DSP stage is a function over a fixed-size block of samples with explicit
carried state:

    y, new_state = block.apply(params, state, x)

  * ``x``/``y`` are tensors shaped ``[..., T]``; leading axes are batched
    VFO channels.  The device follows the input tensor.
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
