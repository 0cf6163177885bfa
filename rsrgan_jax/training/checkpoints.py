"""Checkpointing with the reference's accept/reject semantics.

tf.train.Saver equivalent (models/gan_rnn_placeholder.py:26-60):
``{save_dir}/{name}-{step}.ckpt`` files, a ``checkpoint`` text file
pointing at the latest, ``max_to_keep`` rotation, and optional EMA-shadow
restore (``moving_average=True``) for eval/decode.

A checkpoint file is a numpy ``.npz`` archive with one array per leaf of
the state, keyed by the leaf's tree path (``g/params/lstm_cell_1/kernel``).
Restoring needs a target state of the same structure; a missing, extra or
reshaped leaf raises ``ValueError`` naming it.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import jax
import numpy as np


def _path_key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def _write_tree(path: str, tree: Any) -> None:
    """Atomically write ``tree`` as an .npz keyed by leaf path: a crash (or
    a concurrent multi-host reader on a shared filesystem) never observes
    a torn checkpoint."""
    arrays = {_path_key(p): np.asarray(jax.device_get(leaf))
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)


def _read_tree(path: str, target: Any) -> Any:
    """The .npz at ``path`` restored into ``target``'s structure."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(target)
    keys = [_path_key(p) for p, _ in flat]
    with np.load(path) as archive:
        missing = [k for k in keys if k not in archive.files]
        extra = sorted(set(archive.files) - set(keys))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not match the model: missing "
                f"{missing[:4]}, unexpected {extra[:4]}")
        leaves = []
        for key, (_, want) in zip(keys, flat):
            got = archive[key]
            if got.shape != np.shape(want):
                raise ValueError(
                    f"checkpoint {path}: {key} has shape {got.shape}, the "
                    f"model expects {np.shape(want)}")
            leaves.append(got)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _checkpoint_file(save_dir: str) -> str:
    return os.path.join(save_dir, "checkpoint")


def _list_checkpoints(save_dir: str, name: str) -> List[str]:
    if not os.path.isdir(save_dir):
        return []
    files = [f for f in os.listdir(save_dir)
             if f.startswith(name + "-") and f.endswith(".ckpt")]
    return sorted(files, key=lambda f: int(f[len(name) + 1:-5]))


def checkpoint_meta_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.meta.json")


def read_checkpoint_meta(save_dir: str, name: str) -> Optional[dict]:
    """The model-config sidecar written by save_checkpoint (None for
    checkpoints from before it existed)."""
    path = checkpoint_meta_path(save_dir, name)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_checkpoint(save_dir: str, name: str, state: Any, step: int,
                    max_to_keep: int = 10,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}-{step}.ckpt")
    _write_tree(path, state)
    if meta is not None:
        # model-config sidecar: lets loaders validate wiring that the
        # parameter tree alone cannot distinguish (e.g. res_lstm_l vs
        # res_lstm_base share an identical tree shape)
        mpath = checkpoint_meta_path(save_dir, name)
        with open(mpath + ".tmp", "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(mpath + ".tmp", mpath)
    with open(_checkpoint_file(save_dir) + ".tmp", "w") as f:
        f.write(os.path.basename(path) + "\n")
    os.replace(_checkpoint_file(save_dir) + ".tmp",
               _checkpoint_file(save_dir))
    for old in _list_checkpoints(save_dir, name)[:-max_to_keep]:
        os.remove(os.path.join(save_dir, old))
    return path


def periodic_snapshot_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.periodic.ckpt")


def save_periodic_snapshot(save_dir: str, name: str, state: Any) -> str:
    """Atomically overwrite the mid-iteration crash-recovery snapshot.

    The reference only checkpoints at iteration/epoch boundaries
    (scripts/train_gan_rnn_placeholder.py:535-554); with hour-long
    iterations a crash loses the whole pass. The snapshot lives outside the
    accepted-checkpoint rotation and never enters the ``checkpoint`` file.
    """
    os.makedirs(save_dir, exist_ok=True)
    path = periodic_snapshot_path(save_dir, name)
    _write_tree(path, state)
    return path


def load_newest_state(save_dir: str, name: str, target: Any):
    """Restore from the latest accepted checkpoint OR a newer periodic
    snapshot. Returns (state_or_None, source_label)."""
    ckpt = latest_checkpoint(save_dir, name)
    snap = periodic_snapshot_path(save_dir, name)
    snap_t = os.path.getmtime(snap) if os.path.isfile(snap) else None
    ckpt_t = os.path.getmtime(ckpt) if ckpt and os.path.isfile(ckpt) else None
    if snap_t is not None and (ckpt_t is None or snap_t > ckpt_t):
        return _read_tree(snap, target), "periodic"
    if ckpt_t is not None:
        return load_checkpoint(save_dir, name, target), "checkpoint"
    return None, None


def latest_checkpoint(save_dir: str, name: str) -> Optional[str]:
    ckpt_file = _checkpoint_file(save_dir)
    if os.path.isfile(ckpt_file):
        with open(ckpt_file) as f:
            candidate = f.read().strip()
        path = os.path.join(save_dir, candidate)
        if os.path.isfile(path):
            return path
    files = _list_checkpoints(save_dir, name)
    return os.path.join(save_dir, files[-1]) if files else None


def load_checkpoint(save_dir: str, name: str, target: Any,
                    model_file: Optional[str] = None,
                    moving_average: bool = False) -> Optional[Any]:
    """Restore ``target``-shaped state from the latest (or named) file.

    With ``moving_average=True``, every NetState's params are replaced by
    its EMA shadow after restore (ExponentialMovingAverage
    variables_to_restore parity, models/gan.py:48-53).
    """
    path = (os.path.join(save_dir, model_file) if model_file
            else latest_checkpoint(save_dir, name))
    if path is None or not os.path.isfile(path):
        return None
    state = _read_tree(path, target)
    if moving_average:
        state = swap_in_ema(state)
    return state


def swap_in_ema(state: Any) -> Any:
    """Replace params with EMA shadows on every NetState in the tree."""
    from rsrgan_jax.training.state import NetState

    def visit(node):
        if isinstance(node, NetState):
            return node.replace(params=jax.tree.map(lambda x: x, node.ema))
        return node

    if isinstance(node := state, NetState):
        return visit(node)
    # train-state dataclasses: rebuild with visited children
    changed = {}
    for field in state.__dataclass_fields__:
        val = getattr(state, field)
        if isinstance(val, NetState):
            changed[field] = visit(val)
    return state.replace(**changed) if changed else state
