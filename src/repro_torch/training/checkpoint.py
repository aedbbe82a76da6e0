"""Checkpoints in the reference's on-disk format (``repro/training/
checkpoint.py``), with async save.

Format: one ``.npy`` per leaf plus ``meta.json``, each file named as the
reference names it (``jax.tree_util.keystr`` of the leaf's path, sanitised:
``params_layers_q.npy``, ``opt_.mu_embed.npy``, ``opt_.step.npy``,
``params_mamba_main_w_z.npy``) and holding the reference's layout, with its
tp axis where the model family's subtree puts it
(``params.subtree_tp_axes``). So a checkpoint
written by the reference's ``Trainer`` restores here, and one written here
restores there. Saves snapshot every leaf to host memory synchronously and
write the files on a background thread (``wait()`` joins it before the
next save).

On a ``(data, model)`` mesh every leaf is gathered whole (``Shard``:
``params.gather_global``) and rank 0 writes it, so the files hold global
arrays as the reference's do; a restore takes each rank's part of them
(``params.local_part``), so a checkpoint restores onto a mesh of any data
size (a MoE's experts, written whole, are split anew over the data axis).
The tp size is in the arrays' shapes and must not change.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..models.params import (gather_global, local_part, subtree_tp_axes,
                             tensor_from_numpy)
from ..models.tp import Dist, Shard


def _walk(node, path: str, name: str, parent: str,
          out: List[Tuple[str, str, str, Any]]):
    """(keystr path, leaf name, parent dict key, leaf) in the reference's
    flatten order: dict keys sorted, NamedTuple fields in order."""
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], f"{path}['{key}']", key, name, out)
    elif hasattr(node, "_fields"):
        for field in node._fields:
            _walk(getattr(node, field), f"{path}.{field}", field, name, out)
    else:
        out.append((path, name, parent, node))


def _leaf_files(tree, family: str) -> List[Tuple[str, str, Any, Any]]:
    """(file name, leaf name, tp-axis map, leaf) for every leaf of
    ``tree``, a ``family`` model's; the map is the leaf's subtree's (a
    hybrid's ``mamba_main`` / ``mamba_tail`` / ``shared_attn``, RWKV6's
    ``layers`` and the enc-dec stacks carry their tp axis elsewhere than
    the dense tree's)."""
    out: List[Tuple[str, str, str, Any]] = []
    _walk(tree, "", "", "", out)
    return [(re.sub(r"[^A-Za-z0-9_.-]+", "_", path).strip("_") + ".npy",
             name, subtree_tp_axes(family, parent), leaf)
            for path, name, parent, leaf in out]


def _rebuild(node, it):
    if isinstance(node, dict):
        return {key: _rebuild(node[key], it) for key in sorted(node)}
    if hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, f), it)
                            for f in node._fields))
    return next(it)


def _shard_list(files, shards) -> List[Shard]:
    """Each leaf's ``Shard``: from ``shards`` (a tree like the saved one),
    or by default its tp axis alone (one device)."""
    if shards is None:
        return [Shard(axes.get(name)) for _, name, axes, _ in files]
    out: List[Tuple[str, str, str, Any]] = []
    _walk(shards, "", "", "", out)
    return [sh for *_, sh in out]


class Checkpointer:
    """Checkpoints of a ``family`` model's trees (the family picks each
    leaf's tp axis on disk) on the ranks of ``dist`` (one device by
    default)."""

    def __init__(self, directory: str, family: str, keep: int = 3,
                 dist: Optional[Dist] = None):
        self.dir = directory
        self.keep = keep
        self.family = family
        self.dist = dist or Dist()
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False, shards: Any = None) -> None:
        """Write ``tree`` (this rank's parts under ``shards``) as global
        arrays: a collective on a mesh, whose rank 0 writes."""
        self.wait()
        # snapshot to host memory synchronously, then write the files on a
        # background thread (async checkpointing)
        files = _leaf_files(tree, self.family)
        host = []
        for (f, name, _, t), sh in zip(files, _shard_list(files, shards)):
            if t.dtype not in (torch.float32, torch.int32):
                raise TypeError(f"{name}: checkpoints hold float32 and "
                                f"int32 leaves, not {t.dtype}")
            g = gather_global(t.detach(), sh, self.dist)
            if self.dist.rank == 0:
                host.append((f, g.to("cpu", copy=True).numpy()))
        if self.dist.rank != 0:
            return
        meta = {"step": int(step), "extra": extra or {},
                "leaves": [f for f, _ in host]}

        def write():
            tmp = tempfile.mkdtemp(dir=self.dir)
            for fname, arr in host:
                np.save(os.path.join(tmp, fname), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as fh:
                json.dump(meta, fh)
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The last complete checkpoint, the same on every rank (rank 0's
        writer is joined first)."""
        self.wait()
        self.dist.barrier()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, device=None,
                shards: Any = None):
        """Load into the structure of ``target_tree`` (tensors, possibly on
        the ``meta`` device, giving each leaf's shape and dtype: this
        rank's parts under ``shards``). Leaves go to ``device`` (default:
        each target leaf's device) in the target's dtype. Returns (tree,
        meta)."""
        self.wait()
        self.dist.barrier()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        leaves = _leaf_files(target_tree, self.family)
        if [f for f, _, _, _ in leaves] != list(meta["leaves"]):
            raise ValueError(f"{d}: tree structure changed")
        out = []
        for (fname, name, axes, ref), sh in zip(
                leaves, _shard_list(leaves, shards)):
            arr = local_part(np.load(os.path.join(d, fname)), sh, self.dist)
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{fname}: shape {arr.shape}, expected "
                                 f"{tuple(ref.shape)}")
            out.append(tensor_from_numpy(arr).to(
                device=ref.device if device is None else device,
                dtype=ref.dtype))
        return _rebuild(target_tree, iter(out)), meta
