"""Atomic, async checkpointing of trees of tensors and arrays.

Format: one directory per step —
    step_000000123/
      meta.json            (step, flat key list, shapes/dtypes, extra)
      arrays.npz           (the flattened tree, host arrays)
      .complete            (commit marker; written LAST)

Writes go to ``<dir>.tmp`` then `os.replace` -> atomic; readers only trust
directories with the commit marker, so a killed writer never corrupts the
latest checkpoint.

A tree is nested dicts, lists, tuples, named tuples and registered nodes
(objects with the reference's ``tree_flatten`` / ``tree_unflatten``
protocol, such as the optimizer's `QTensor`) whose leaves are tensors,
numpy arrays or Python scalars (``None`` is an empty subtree).  Its flat
keys are the reference's ``jax.tree_util.keystr`` (``['Jm']``,
``['nested']['v']``, ``[0]``, a named tuple's field as ``.step``, a
registered node's children as ``[<flat index 0>]``), so a directory
written by either package loads in the other, training state included.
Tensors are saved from the host and restored to the device and dtype of
the caller's ``target``.  numpy cannot store bfloat16: such a leaf is
stored as its uint16 bits under the key ``__bf16__<key>``, and
meta.json's ``logical_dtypes`` records it.

`AsyncCheckpointer` overlaps serialization with the next train step
(one-deep queue).  Counterpart of ``repro.checkpoint.checkpoint``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_MARKER = ".complete"
_BF16 = "__bf16__"


def _children(tree: Any):
    """``(key suffix, child)`` pairs of an inner node, in the reference's
    key format and order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if hasattr(tree, "tree_flatten"):
        return [(f"[<flat index {i}>]", v)
                for i, v in enumerate(tree.tree_flatten()[0])]
    return None


def _rebuilt(tree: Any, children: list) -> Any:
    """``tree``'s kind of node over new ``children`` (in `_children`
    order)."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    if isinstance(tree, (list, tuple)):
        return type(tree)(children)
    return type(tree).tree_unflatten(tree.tree_flatten()[1], children)


def _leaves(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of ``tree`` in the reference's key format."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaves(child, prefix + key)


def _map_keyed(fn, tree: Any, prefix: str = "", is_leaf=None) -> Any:
    """``fn(key, leaf)`` over the leaves, the structure kept; a node for
    which ``is_leaf`` holds is a leaf too."""
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) \
        else _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuilt(tree, [_map_keyed(fn, child, prefix + key, is_leaf)
                           for key, child in kids])


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf as a host copy: a numpy array, or a CPU tensor for
    bfloat16 (which numpy cannot hold)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    out = {}
    for key, leaf in _leaves(tree):
        arr = _host(leaf)
        if isinstance(arr, torch.Tensor):      # bfloat16
            out[_BF16 + key] = arr.view(torch.int16).numpy().view(np.uint16)
        elif arr.dtype.name == "bfloat16":     # a numpy extension dtype
            out[_BF16 + key] = arr.view(np.uint16)
        else:
            out[key] = arr
    return out


def _unflatten_arrays(arrays: dict[str, np.ndarray]) -> dict:
    """Stored arrays by key; bfloat16 ones as CPU bfloat16 tensors."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(_BF16):
            out[k[len(_BF16):]] = torch.from_numpy(
                v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = v
    return out


def save(directory: str | Path, step: int, tree: Any,
         extra: Optional[dict] = None) -> Path:
    """Blocking atomic save. Returns the committed checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = _flatten(tree)
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {
        "step": step,
        "keys": list(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "logical_dtypes": {k[len(_BF16):]: "bfloat16" for k in arrays
                           if k.startswith(_BF16)},
        "extra": extra or {},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / _MARKER).touch()
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.name.startswith("step_") and not p.name.endswith(".tmp")
             and (p / _MARKER).exists()]
    return max(steps) if steps else None


def _restore(val, leaf):
    """A stored value in the form of the target's leaf: a tensor on the
    leaf's device with its dtype, an array of its dtype, or a scalar."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(val).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return np.asarray(val).astype(leaf.dtype)
    return type(leaf)(np.asarray(val).item())


def _rebuild(target: Any, arrays: dict):
    def leaf(key, value):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        return _restore(arrays[key], value)
    return _map_keyed(leaf, target)


def load(directory: str | Path, step: Optional[int] = None,
         target: Any = None) -> tuple[int, Any, dict]:
    """Load (step, tree, extra).  Without ``target`` the tree is the flat
    ``{key: array}`` dict; with it, the target's structure, each leaf
    restored to the target leaf's device and dtype."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = directory / f"step_{step:09d}"
    if not (path / _MARKER).exists():
        raise FileNotFoundError(f"checkpoint {path} incomplete")
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz") as data:
        arrays = _unflatten_arrays({k: data[k] for k in data.files})
    if target is None:
        return step, arrays, meta["extra"]
    return step, _rebuild(target, arrays), meta["extra"]


def gc_old(directory: str | Path, keep: int = 3) -> None:
    directory = Path(directory)
    if not directory.exists():
        return
    steps = sorted(
        p for p in directory.iterdir()
        if p.name.startswith("step_") and (p / _MARKER).exists())
    for p in steps[:-keep]:
        shutil.rmtree(p)


def _to_host(tree: Any) -> Any:
    return _map_keyed(lambda _, leaf: _host(leaf), tree)


class AsyncCheckpointer:
    """One-deep background writer: save() returns immediately; a second
    save blocks until the first commit finishes (bounded staleness)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        # snapshot to host before returning control to the train loop
        host_tree = _to_host(tree)

        def _run():
            try:
                save(self.directory, step, host_tree, extra)
                gc_old(self.directory, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
