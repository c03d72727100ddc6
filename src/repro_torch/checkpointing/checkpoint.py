"""Tree checkpointing (port of ``repro.checkpointing.checkpoint``): one
``ckpt_{step:08d}.npz`` per step, written to a temporary file in the same
directory and moved into place with ``os.replace``, so a save that is killed
leaves no half file for ``latest_step`` to pick up.

A tree is what the launcher and the segment runner carry: dicts (keys
sorted, as ``jax.tree`` sorts them), tuples (``Groups`` included), lists,
dataclasses (``FedState``, ``AlgoState``, ``BufferState``), ``None``, and
leaves: tensors of any dtype, Python ints and bools (such as
``FedState.round`` and a drawer's draw counts) and ``torch.Generator`` s
(their ``get_state()``). ``restore(path, step, template)`` rebuilds the
template's structure from the file and raises where the structure, a
leaf's shape or its dtype differs. numpy has no bfloat16 (nor the float8
types): such a tensor is stored as the integer of its width, its dtype
recorded, and comes back bit for bit. A tensor or a generator comes back on
the template's device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step"]

def _kind(x) -> str:
    if isinstance(x, torch.Tensor):
        return "tensor"
    if isinstance(x, torch.Generator):
        return "generator"
    if isinstance(x, int):
        return type(x).__name__            # int or bool
    raise TypeError(f"a checkpoint leaf is a tensor, a generator, an int or "
                    f"a bool; got {type(x)}")


def _flatten(tree, path: str = "") -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path, leaf), ...], structure)``: the leaves in order and a
    JSON-able description of the nodes around them."""
    if tree is None:
        return [], None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        kids = [getattr(tree, n) for n in names]
        node = [type(tree).__name__, names]
    elif isinstance(tree, dict):
        names = sorted(tree, key=str)
        kids = [tree[k] for k in names]
        node = ["dict", [str(k) for k in names]]
    elif isinstance(tree, (tuple, list)):
        names = list(range(len(tree)))
        kids = list(tree)
        node = [type(tree).__name__, len(tree)]
    else:
        return [(path or ".", tree)], _kind(tree)
    leaves, inner = [], []
    for name, kid in zip(names, kids):
        sub, s = _flatten(kid, f"{path}.{name}" if path else str(name))
        leaves += sub
        inner.append(s)
    return leaves, node + [inner]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves)
               for k in sorted(template, key=str)}
        return {k: out[k] for k in template}
    if isinstance(template, list):
        return [_unflatten(x, leaves) for x in template]
    if isinstance(template, tuple):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype it is restored to."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy(), "generator"
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), type(leaf).__name__
    t = leaf.detach().cpu()
    try:
        return t.numpy(), str(t.dtype)
    except TypeError:      # bfloat16, float8: no numpy dtype; keep the bits
        bits = {1: torch.int8, 2: torch.int16}[t.element_size()]
        return t.view(bits).numpy(), str(t.dtype)


def save(path: str, step: int, tree) -> str:
    """Write ``tree`` as ``path/ckpt_{step:08d}.npz`` (atomically) and
    return the file's name."""
    os.makedirs(path, exist_ok=True)
    leaves, structure = _flatten(tree)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(leaves):
        arrays[f"leaf_{i}"], dt = _stored(leaf)
        dtypes.append(dt)
    meta = {"structure": structure, "paths": [p for p, _ in leaves],
            "dtypes": dtypes}
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    tmp = tempfile.NamedTemporaryFile(dir=path, delete=False, suffix=".tmp")
    try:
        with tmp:
            np.savez(tmp, meta=np.asarray(json.dumps(meta)), **arrays)
        os.replace(tmp.name, fname)
    except BaseException:
        os.unlink(tmp.name)
        raise
    return fname


def latest_step(path: str):
    """The largest step saved in ``path``, or ``None``."""
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def _restored(name: str, arr: np.ndarray, saved_dtype: str, template):
    """One stored leaf as the template's kind (the structure, leaf kinds
    included, matched already), checked against its dtype and shape."""
    kind = _kind(template)
    if kind == "generator":
        g = torch.Generator(device=template.device)
        g.set_state(torch.from_numpy(arr))
        return g
    if kind != "tensor":
        return type(template)(arr.item())
    if saved_dtype != str(template.dtype):
        raise ValueError(f"leaf {name}: dtype {saved_dtype}, the template's "
                         f"is {template.dtype}")
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"leaf {name}: shape {tuple(arr.shape)}, the "
                         f"template's is {tuple(template.shape)}")
    t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    if t.dtype != template.dtype:
        t = t.view(template.dtype)
    return t.to(template.device)


def restore(path: str, step: int, template):
    """The tree saved at ``step``, in the structure of ``template``: every
    leaf's kind, shape and dtype must match the template's (``ValueError``
    otherwise) and lands on the template leaf's device."""
    leaves, structure = _flatten(template)
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as data:
        meta: Dict = json.loads(str(data["meta"]))
        if meta["structure"] != json.loads(json.dumps(structure)):
            raise ValueError(
                f"the checkpoint's structure differs from the template's: "
                f"{len(meta['paths'])} leaves {meta['paths'][:8]}... against "
                f"{len(leaves)} {[p for p, _ in leaves][:8]}...")
        new = [_restored(p, data[f"leaf_{i}"], meta["dtypes"][i], leaf)
               for i, (p, leaf) in enumerate(leaves)]
    return _unflatten(template, iter(new))
