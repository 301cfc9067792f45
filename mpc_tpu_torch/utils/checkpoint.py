"""Checkpoint and resume of long scenario suites (port of
mpc_tpu/utils/checkpoint.py).

A tree of tensors (dicts, NamedTuples, tuples and lists of them) is saved
as one flat ``.npz`` archive, written atomically, with a step record. Each
leaf is keyed by its path, spelled as ``jax.tree_util.keystr`` spells it
(``['carries'].sigma``, ``['carry'][0]``), so a checkpoint written by either
package loads in the other where the trees have the same fields, as the
carries of both packages do. Shapes and dtypes are checked on load: a
checkpoint of another structure fails with a clear "incompatible
checkpoint" error instead of a KeyError or a silent mis-assignment.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, List, Tuple

import numpy as np
import torch

_STEP_KEY = "__step__"
_PATH_PREFIX = "path:"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the order jax flattens the tree: dict keys
    sorted, NamedTuple fields and sequence items in order; None holds no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f),
                                              f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_with_paths(x, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree: Any, leaves: dict, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    return leaves[path]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> str:
    """Atomically save a tree of tensors to ``path`` (.npz)."""
    arrays = {_PATH_PREFIX + k: _to_numpy(v)
              for k, v in _flatten_with_paths(tree)}
    arrays[_STEP_KEY] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, example_tree: Any) -> Tuple[Any, int]:
    """Load a tree saved by :func:`save_checkpoint` (of either package).

    ``example_tree`` gives the structure and the expected shapes and
    dtypes; a tensor leaf comes back as a tensor on the example leaf's
    device, any other leaf as a numpy array. Raises ``ValueError`` naming
    the offending leaves when the checkpoint does not match: missing or
    extra paths, or a shape or dtype mismatch.
    """
    expected = _flatten_with_paths(example_tree)
    with np.load(path) as data:
        saved = {k[len(_PATH_PREFIX):]: data[k] for k in data.files
                 if k.startswith(_PATH_PREFIX)}
        if _STEP_KEY not in data.files:
            raise ValueError(
                f"incompatible checkpoint {path!r}: no step record "
                "(not written by save_checkpoint?)")
        step = int(data[_STEP_KEY])

    missing = [k for k, _ in expected if k not in saved]
    extra = sorted(set(saved) - {k for k, _ in expected})
    if missing or extra:
        raise ValueError(
            f"incompatible checkpoint {path!r}: "
            f"missing leaves {missing}, unexpected leaves {extra} "
            "(pytree structure changed since the checkpoint was written)")

    leaves, bad = {}, []
    for k, ex in expected:
        arr = saved[k]
        ex_arr = _to_numpy(ex)
        if arr.shape != ex_arr.shape or arr.dtype != ex_arr.dtype:
            bad.append(f"{k}: saved {arr.dtype}{list(arr.shape)} vs expected "
                       f"{ex_arr.dtype}{list(ex_arr.shape)}")
        leaves[k] = torch.as_tensor(arr, device=ex.device) \
            if isinstance(ex, torch.Tensor) else arr
    if bad:
        raise ValueError(
            f"incompatible checkpoint {path!r}: shape/dtype mismatch — "
            + "; ".join(bad))
    return _unflatten(example_tree, leaves), step
