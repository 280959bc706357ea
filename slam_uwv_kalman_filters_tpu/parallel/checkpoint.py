"""Checkpoint / resume for filter banks.

The reference's only "resume" is its second constructor from an explicit
state+covariance (``/root/reference/src/PoseUKF.cpp:374-391``). Here the whole
filter-bank state is a pytree, so a checkpoint is the tree's flattened leaves
in one NumPy ``.npz`` file (``leaf_0`` … ``leaf_{n-1}`` in
``jax.tree_util`` flatten order — host-portable, needs nothing beyond NumPy),
and resume is exactly the reference's construct-from-state path
(``models.pose_ukf.init_from_state``). The tree structure comes from the
restore template, so only the leaves are stored.

For multi-process jobs each process saves its addressable shard
(``save_sharded``); restore re-places shards onto the local mesh.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import jax
import numpy as np

__all__ = ["save", "restore", "save_sharded", "restore_sharded"]


def save(path: str | os.PathLike, tree: Any) -> None:
    """Serialize a pytree (filter state, params, or both) to ONE ``.npz``
    file, atomically published (written beside ``path``, then renamed)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(tree)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    os.replace(tmp, path)


def restore(path: str | os.PathLike, target: Any) -> Any:
    """Restore into the structure of ``target`` (a template pytree — e.g. a
    freshly-initialized filter state). Returns host NumPy arrays with the
    saved shapes and dtypes; callers device-put as needed. A file whose leaf
    count differs from the template's raises ``ValueError``."""
    leaves, treedef = jax.tree_util.tree_flatten(target)
    with np.load(Path(path), allow_pickle=False) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(data.files)} leaves; the "
                f"template has {len(leaves)}"
            )
        restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, restored)


def _shard_path(path: Path, process_index: int) -> Path:
    return path.with_name(f"{path.name}.shard{process_index}")


def _local_host_view(a) -> np.ndarray:
    """This process's view of an array: the unique addressable shards
    concatenated along axis 0. Replicated leaves (params saved alongside the
    bank) have one identical shard per local device — deduplicating by shard
    index keeps them single-copy instead of k× duplicated. Rank-0 leaves
    (ring-buffer heads, counters) are necessarily replicated → full value."""
    if hasattr(a, "addressable_shards") and getattr(a, "ndim", 0) > 0:
        by_offset = {}
        for s in a.addressable_shards:
            # slice objects are unhashable (py<3.12): key on the start offsets
            key = tuple(sl.start or 0 for sl in s.index)
            by_offset.setdefault(key, s)
        shards = [by_offset[k] for k in sorted(by_offset)]
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    return np.asarray(a)


def save_sharded(path: str | os.PathLike, tree: Any) -> None:
    """Each process saves the locally-addressable part of a sharded bank."""
    path = Path(path)
    save(_shard_path(path, jax.process_index()), jax.tree_util.tree_map(_local_host_view, tree))


def restore_sharded(path: str | os.PathLike, target: Any, *, place: bool = False) -> Any:
    """Restore this process's shard (single process: shard 0).

    ``target`` is a template with this process's layout — e.g. the freshly
    initialized, already-sharded bank. Restored leaf shapes are validated
    against the template's host-local view (what ``save_sharded`` wrote), so
    a template of the wrong bank size fails loudly instead of silently
    carrying mismatched shards. With ``place=True`` each leaf is re-assembled
    onto the template's sharding (``jax.make_array_from_process_local_data``)
    — the multi-process resume path; the default returns host numpy arrays."""
    host_target = jax.tree_util.tree_map(_local_host_view, target)
    restored = restore(_shard_path(Path(path), jax.process_index()), host_target)

    def _check(r, t):
        if np.shape(r) != np.shape(t):
            raise ValueError(
                f"checkpoint shard shape {np.shape(r)} does not match the "
                f"template's local shape {np.shape(t)} — pass a target with "
                "this process's bank layout (same global size and sharding "
                "as at save time)"
            )
        return r

    restored = jax.tree_util.tree_map(_check, restored, host_target)
    if not place:
        return restored

    def _place(r, t):
        if hasattr(t, "sharding") and hasattr(t, "addressable_shards"):
            return jax.make_array_from_process_local_data(t.sharding, np.asarray(r))
        return r

    return jax.tree_util.tree_map(_place, restored, target)
