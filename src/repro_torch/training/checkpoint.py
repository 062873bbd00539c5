"""Minimal npz checkpointing for parameter and optimizer trees.

Port of ``repro/training/checkpoint.py``, in its file layout: one flat
``.npz`` whose keys are the tree's paths joined by ``/`` (``stages/
stage_0/attn/wq``), one array per leaf.  f32 (and integer) leaves are
stored as numpy arrays of their dtype, so f32 checkpoints pass between
the two packages in both directions.

bf16 leaves: numpy has no bfloat16, and the card's machine has no
``ml_dtypes``.  A bf16 leaf is stored as its raw 16-bit patterns in a
2-byte void array (numpy dtype ``V2``), which is what ``np.savez`` writes
for the reference's ``ml_dtypes.bfloat16`` leaves too; ``restore``
reads every ``V2`` array back as those bits viewed as ``torch.bfloat16``
(and an ``ml_dtypes.bfloat16`` array, where one is handed in, the same
way), so a bf16 tree round-trips bit for bit.  A step counter (a Python
int) is stored as a 0-d int64 array and restored as a 0-d tensor (as an int with ``like``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

_BF16_RAW = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RAW)
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == _BF16_RAW or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save(path: str, tree):
    """Write ``tree`` (nested dicts of tensors) to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def _cast(t, like):
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, int):            # the optimizer's step
        return int(t)
    return t


def restore(path: str, like=None):
    """The tree saved at ``path`` as CPU tensors; with ``like`` (a tree of
    the same paths), each leaf cast to ``like``'s dtype and moved to its
    device."""
    with np.load(path) as data:
        tree = _unflatten({k: _to_tensor(data[k]) for k in data.files})
    if like is None:
        return tree

    def walk(t, l):
        if isinstance(t, dict):
            return {k: walk(v, l[k]) for k, v in t.items()}
        return _cast(t, l)

    return walk(tree, like)
