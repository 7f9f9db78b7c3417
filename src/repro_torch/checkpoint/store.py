"""Pytree checkpointing: flat npz with '/'-joined key paths (mirrors
``repro.checkpoint.store``; the archives are interchangeable).

A tree is nested dicts, tuples and lists whose leaves are tensors, numpy
arrays or Python scalars; ``None`` is an empty subtree. A named tuple's
fields are keyed by name. Tensors go to host numpy on save (bfloat16 widens
to float32, which npz can store) and come back on the caller's device.

Crash safety: :func:`save_pytree` writes a sibling temp file, fsyncs it and
``os.replace``s it into place, so the checkpoint's path always names the
previous complete archive or the new one. Every loader turns a truncated or
corrupt archive, and drift in the key set or a shape, into ``ValueError``.

Two loading modes:

  * :func:`load_pytree`: ``like`` supplies the structure, shapes and
    dtypes, and the stored key set must match it exactly;
  * :func:`load_flat` + :func:`restore_subtree`: read the raw
    ``{key path: array}`` dict, then rebuild the sub-trees that have a
    constructible reference (parameter stacks). This is for states whose
    shapes are known only at run time (the orchestrator's run state).
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Dict

import numpy as np
import torch


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _children(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    return enumerate(tree)


def flatten_with_keys(tree, prefix: str = ""):
    """``[(key path, leaf)]`` of ``tree``, paths joined with '/'."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, sub in _children(tree):
        out += flatten_with_keys(sub, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree, values: dict, prefix: str = ""):
    """A tree shaped like ``tree`` with each leaf replaced by
    ``values[key path]``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return values[prefix]
    items = {k: _unflatten(sub, values, f"{prefix}/{k}" if prefix else str(k))
             for k, sub in _children(tree)}
    if isinstance(tree, dict):
        return items
    vals = list(items.values())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    arr = np.asarray(v)
    if arr.dtype.kind not in "biufc":   # e.g. numpy's bfloat16 extension
        arr = arr.astype(np.float32)
    return arr


def save_pytree(path: str, tree: Any) -> None:
    """Atomically serialise ``tree`` to ``path`` (see module docstring)."""
    arrays = {k: _to_numpy(v) for k, v in flatten_with_keys(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open_npz(path: str):
    """np.load with corrupt/truncated archives surfaced as ValueError."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: {e}") \
            from None


def _ref(ref):
    """A reference leaf with ``shape`` and ``dtype`` (Python scalars too)."""
    return ref if hasattr(ref, "shape") else np.asarray(ref)


def _restore(arr: np.ndarray, ref, device):
    dtype = ref.dtype if isinstance(ref.dtype, torch.dtype) else \
        torch.from_numpy(np.zeros(0, ref.dtype)).dtype
    return torch.as_tensor(np.array(arr, copy=True), device=device).to(dtype)


def load_pytree(path: str, like: Any, device="cpu") -> Any:
    """Load a tree saved by :func:`save_pytree`; ``like`` (leaves with
    ``shape`` and ``dtype``: tensors, meta tensors or numpy arrays)
    supplies the structure, shapes and dtypes. Missing or unexpected keys
    and shape drift raise ``ValueError``."""
    with _open_npz(path) as data:
        flat = flatten_with_keys(like)
        expected = [k for k, _ in flat]
        missing = [k for k in expected if k not in data.files]
        extra = sorted(set(data.files) - set(expected))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path!r} does not match the reference tree: "
                f"missing keys {missing or 'none'}, "
                f"unexpected keys {extra or 'none'}")
        try:
            stored = {k: data[k] for k in expected}
        except (zipfile.BadZipFile, OSError, EOFError, ValueError) as e:
            raise ValueError(
                f"corrupt or truncated checkpoint {path!r}: {e}") from None
    vals = {}
    for k, ref in flat:
        ref = _ref(ref)
        arr = stored[k]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint {path!r}: shape mismatch at {k!r}: stored "
                f"{tuple(arr.shape)} != expected {tuple(ref.shape)}")
        vals[k] = _restore(arr, ref, device)
    return _unflatten(like, vals)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint as a raw ``{key path: np.ndarray}`` dict. The whole
    archive is read at once, so a truncated member fails here, not in the
    middle of a restore."""
    with _open_npz(path) as data:
        try:
            return {k: data[k] for k in data.files}
        except (zipfile.BadZipFile, OSError, EOFError, ValueError) as e:
            raise ValueError(
                f"corrupt or truncated checkpoint {path!r}: {e}") from None


def restore_subtree(flat: Dict[str, np.ndarray], prefix: str, like: Any,
                    device="cpu"):
    """Rebuild ``like``'s tree from a :func:`load_flat` dict whose keys were
    saved under ``prefix``. Missing keys and shape drift raise
    ``ValueError`` naming the path."""
    vals = {}
    for sub, ref in flatten_with_keys(like):
        ref = _ref(ref)
        k = f"{prefix}/{sub}" if sub else prefix
        if k not in flat:
            raise ValueError(f"checkpoint missing key {k!r} "
                             f"(restoring subtree {prefix!r})")
        arr = flat[k]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint shape mismatch at {k!r}: stored "
                f"{tuple(arr.shape)} != expected {tuple(ref.shape)}")
        vals[sub] = _restore(arr, ref, device)
    return _unflatten(like, vals)
