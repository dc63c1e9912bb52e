"""Map runtime params and carried state between the JAX package and the
port.

In an SDR the "weights" are the designed taps and the runtime params. Both
packages design their taps deterministically from the same numpy code
(pinned equal by test); the runtime params and the carried state are trees
(dicts and lists) of arrays with the same keys, shapes and dtypes on both
sides — the per-radio (``Radio.apply``, with its lists of decimator and
MPX tails, the PLL dict and ``audio_rs`` [2, ..., hist]), IQFrontEnd,
shared-VFO and channelized layouts alike (int32 bin indices, complex64
filter tails, float32 audio tails), and the EFFT compressor's
(``ops/efft_device.py``: its complex64 and float32 rings, int32 ``count``,
float32 ``prev_allowance``), and the transmit path's (``models/trx.py``:
``TxChain``'s AGC ``amp`` and ``env`` and its modulator's — the FM phase,
a float32 scalar, or the SSB FIR's complex64 tail — and ``ServerTxPath``'s
resampler tail), and the digital demods' (``ops/demod_digital.py`` and
``models/meteor.py``: the AGC's, the Costas loop's ``phase`` and
``freq``, the RRC's tail, the clock recovery's ``tail``, ``phase``,
``freq``, int32 ``offset`` and its symbol history, ``Pi4DQPSKDemod``'s
``prev`` and ``bias``, ``FourFSKDemod``'s ``c_in`` and ``c_out``,
Meteor's ``last_q``) — and these functions convert them leaf by leaf. A tree
that the JAX package's ``runtime/checkpoint.load_state`` returned (numpy
leaves) converts the same way, so that a checkpoint the JAX package saved
continues in the port; the port's own ``runtime/checkpoint.py`` reads that
file too. Anything with ``__array__`` (numpy arrays, or the JAX package's
device arrays) is read through numpy, so this module imports nothing of
JAX. The port's trees go to the device the caller names: there is no
default.
"""

from __future__ import annotations

import numpy as np
import torch


def _from(tree, device):
    if tree is None:                 # a stateless block's state
        return None
    if isinstance(tree, dict):
        return {k: _from(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_jax(tree, *, device):
    """JAX-package params tree → the port's tensors on ``device``."""
    return _from(tree, device)


def state_from_jax(tree, *, device):
    """JAX-package state tree → the port's tensors on ``device``."""
    return _from(tree, device)


def state_to_jax(tree):
    """The port's state (or params) tree → numpy arrays (what the JAX
    package's blocks take)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: state_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [state_to_jax(v) for v in tree]
    return tree.detach().cpu().numpy()
