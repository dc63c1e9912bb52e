"""Carried-state migration across pipeline reconfiguration (counterpart
of sdrplusplusbrown_tpu/runtime/migrate.py, over the port's state trees:
dicts, lists and tuples of tensors).

The reference preserves DSP state through live reconfiguration: FIR
history survives tap-count changes (zero-extend / truncate,
ref: core/src/dsp/filter/fir.h:33-54) and the whole graph edit happens
under tempStop/tempStart without flushing loop state
(ref: decoder_modules/radio/src/radio_module.h:655-774), so a bandwidth
change or demod switch is click-free.  The state is an explicit tree, so
migration is a structural merge, leaf by leaf at the same path:

* identical shape → carry the old leaf (cast to the new dtype);
* same rank, same leading dims, different LAST axis → align RIGHT
  (state vectors are overlap-save histories ordered oldest→newest:
  keep the newest samples, zero-fill the unknown older past — exactly
  the reference's FIR resize rule);
* anything else (new key, rank change, dtype-kind change, leading-dim
  change) → the fresh template leaf.

``migrate_state(old, template)`` never fails: worst case it returns the
template (a cold init), best case the whole state carries over.  Carried
leaves go to the template leaf's device.
"""

from __future__ import annotations

import torch


def _kind(t: torch.Tensor) -> str:
    if t.is_complex():
        return "c"
    if t.is_floating_point():
        return "f"
    if t.dtype == torch.bool:
        return "b"
    return "u" if t.dtype == torch.uint8 else "i"


def _leaf_migrate(old, new):
    if old is None:
        return new
    if not isinstance(new, torch.Tensor):
        # python scalar / aux value: carry when same type
        return old if type(old) is type(new) else new
    if not isinstance(old, torch.Tensor):
        return new
    ko, kn = _kind(old), _kind(new)
    if ko != kn and not (ko in "fc" and kn in "fc"):
        return new
    if ko == "c" and kn == "f":
        return new                       # complex → real: incompatible
    if old.ndim != new.ndim:
        return new
    old = old.to(device=new.device, dtype=new.dtype)
    if old.shape == new.shape:
        return old
    if old.ndim == 0 or old.shape[:-1] != new.shape[:-1]:
        return new
    n_old, n_new = old.shape[-1], new.shape[-1]
    if n_old >= n_new:                   # truncate: keep newest samples
        return old[..., n_old - n_new:]
    return torch.cat([torch.zeros_like(new[..., :n_new - n_old]), old],
                     dim=-1)


def _flatten(tree, path: str, out: dict):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out[path] = tree


def _merge(old_map: dict, template, path: str):
    if isinstance(template, dict):
        return {k: _merge(old_map, v, f"{path}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_merge(old_map, v, f"{path}[{i}]")
                              for i, v in enumerate(template))
    return _leaf_migrate(old_map.get(path), template)


def migrate_state(old_state, template):
    """Merge ``old_state`` into the shape of ``template`` (a fresh
    ``init_state`` tree of the NEW pipeline) using the resize rules
    above.  Leaves of ``template`` with no matching path in
    ``old_state`` stay fresh."""
    if old_state is None:
        return template
    old_map: dict = {}
    _flatten(old_state, "", old_map)
    return _merge(old_map, template, "")
