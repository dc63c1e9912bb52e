"""DSP-state checkpointing (counterpart of
sdrplusplusbrown_tpu/runtime/checkpoint.py).

The reference has config-level persistence only — DSP state (filter tails,
PLL phases, noise histories) is ephemeral in mutable blocks (SURVEY §5).
Here every pipeline's state is an explicit tree of tensors, so
checkpoint/resume is a feature: save mid-stream, restart the process,
resume bit-exact.

The file is the JAX package's ``.npz`` layout: ``leaf_i`` in the order
``jax.tree_util`` flattens the same tree (a dict's keys sorted, a list or
tuple in order, None no leaf) and ``__meta__`` (JSON); the structure comes
from the loader's ``like``, so the JAX file's ``__treedef__`` (read by
neither package) is not written. The port's state trees carry the JAX
package's keys, shapes and dtypes, so a checkpoint either package saved
loads in the other.
"""

from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch


def _flatten(tree: Any, out: List) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)


def flatten(tree: Any) -> List:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order."""
    out: List = []
    _flatten(tree, out)
    return out


def _unflatten(like: Any, leaves) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _spec(leaf) -> Tuple[tuple, np.dtype]:
    """A leaf's shape and numpy dtype, without a copy off the device."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty((), dtype=leaf.dtype).numpy().dtype)
    a = np.asarray(leaf)
    return a.shape, a.dtype


def save_state(path: str, state: Any, meta: dict | None = None):
    """Save a tree of tensors (or arrays) to ``path`` (.npz)."""
    arrays = {f"leaf_{i}": _host(l) for i, l in enumerate(flatten(state))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore a tree saved by either package's ``save_state``; ``like``
    (a freshly initialized state of the same pipeline) supplies the
    structure, each leaf's shape and dtype, and the device each leaf
    loads onto.  A leaf that differs in shape or dtype raises."""
    with np.load(path) as data:
        want = flatten(like)
        leaves = []
        for i, ref in enumerate(want):
            arr = data[f"leaf_{i}"]
            shape, dtype = _spec(ref)
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: saved "
                    f"{arr.shape}/{arr.dtype} vs expected "
                    f"{shape}/{dtype} — pipeline config changed?")
            if isinstance(ref, torch.Tensor):
                arr = torch.from_numpy(arr).to(ref.device)
            leaves.append(arr)
        meta = json.loads(bytes(data["__meta__"]).decode()) \
            if "__meta__" in data else {}
    return _unflatten(like, iter(leaves)), meta
