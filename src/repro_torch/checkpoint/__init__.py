"""Checkpointing: numpy ``.npz`` of a flattened tree + JSON manifest.

The reference's file layout and crash-safety contract, which a
long-running :class:`~repro_torch.launch.service.FederatedService`
leans on:

* **Step dirs are atomic.**  Arrays and manifest are staged into a
  ``tmp*`` scratch dir and ``os.rename``'d into ``step_XXXXXXXX`` in one
  call, so a step directory is either absent or complete.
* **The ``LATEST`` pointer is atomic and advisory.**  It is written via
  temp-file + ``os.replace``; :func:`latest_step` treats a missing,
  truncated, corrupt or stale pointer as a miss and scans the
  ``step_*`` dirs instead.
* **Crashed saves are garbage-collected.**  The next :func:`save`
  removes orphaned ``tmp*`` entries (one process saves into a
  ``ckpt_dir`` at a time).
* **Retention.**  ``save(..., keep=K)`` prunes all but the newest K step
  dirs after the new one lands.
* **Restores are path-checked.**  :func:`restore` compares the
  manifest's leaf paths with the target tree's and raises a
  ``ValueError`` listing the difference, so leaves never land in the
  wrong slots.
* :func:`restore_tree` rebuilds the saved tree (nested dicts of numpy
  arrays) with no template and returns the JSON ``meta`` of the save.

A tree is a leaf (a tensor or an array) or a dict of trees; its leaves
are ordered by their paths, the dict keys sorted and joined by ``/``
(the reference's ``jax.tree_util`` order for dicts).  Tensors are saved
from the host (``.cpu().numpy()``); :func:`restore` puts each leaf on
its target's device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

_STEP_PREFIX = "step_"
_TMP_PREFIX = "tmp"


def _flatten_with_paths(tree):
    """(paths, leaves) in sorted-path order; None is an empty subtree."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif node is not None:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return None if node is None else next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_name(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def gc_tmp(ckpt_dir: str) -> list[str]:
    """Remove orphaned ``tmp*`` staging entries left by crashed saves
    (files and dirs).  Returns the removed names."""
    removed = []
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return removed
    for name in entries:
        if not name.startswith(_TMP_PREFIX):
            continue
        path = os.path.join(ckpt_dir, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.remove(path)
            except OSError:
                continue
        removed.append(name)
    return removed


def steps(ckpt_dir: str) -> list[int]:
    """Sorted step numbers of the complete ``step_*`` dirs on disk."""
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    out = []
    for name in entries:
        if not name.startswith(_STEP_PREFIX) or \
                not os.path.isdir(os.path.join(ckpt_dir, name)):
            continue
        try:
            out.append(int(name[len(_STEP_PREFIX):]))
        except ValueError:
            continue
    return sorted(out)


def _write_latest(ckpt_dir: str, name: str):
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=_TMP_PREFIX)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def save(ckpt_dir: str, step: int, tree, *, meta: dict | None = None,
         keep: int | None = None) -> str:
    """Write one checkpoint; returns its step dir.  ``meta`` is a
    JSON-serializable dict stored in the manifest; ``keep`` retains only
    the newest ``keep`` step dirs after this one lands."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must retain at least the checkpoint "
                         f"being written, got keep={keep}")
    paths, leaves = _flatten_with_paths(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    gc_tmp(ckpt_dir)
    target = os.path.join(ckpt_dir, _step_name(step))
    tmp = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=ckpt_dir)
    try:
        arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "paths": paths, "meta": meta or {}}, f)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.rename(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_latest(ckpt_dir, os.path.basename(target))
    if keep is not None:
        for old in steps(ckpt_dir)[:-keep]:
            if old != step:
                shutil.rmtree(os.path.join(ckpt_dir, _step_name(old)),
                              ignore_errors=True)
    return target


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step on disk: the ``LATEST`` pointer if it names a step
    dir, else a scan of the ``step_*`` dirs (None when neither has
    one)."""
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            step = int(f.read().strip().split("_")[-1])
        if os.path.isdir(os.path.join(ckpt_dir, _step_name(step))):
            return step
    except (FileNotFoundError, ValueError):
        pass
    found = steps(ckpt_dir)
    return found[-1] if found else None


def _resolve_step(ckpt_dir: str, step: int | None) -> str:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, _step_name(step))
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no checkpoint dir {d}")
    return d


def _load_manifest(step_dir: str) -> dict:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            return json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"checkpoint {step_dir} has no "
                                "manifest.json") from None


def load_meta(ckpt_dir: str, step: int | None = None) -> dict:
    """The JSON ``meta`` dict recorded by :func:`save` (empty if the
    save passed none)."""
    return _load_manifest(_resolve_step(ckpt_dir, step)).get("meta", {})


def restore(ckpt_dir: str, target_tree, step: int | None = None):
    """Restore into the structure of ``target_tree``: the saved leaf
    paths must equal the target's (a difference raises a ``ValueError``
    that lists it), and each leaf's shape too.  A tensor leaf comes back
    as a tensor on its target's device and dtype, any other leaf as a
    numpy array of its target's dtype."""
    d = _resolve_step(ckpt_dir, step)
    saved_paths = _load_manifest(d)["paths"]
    paths, leaves = _flatten_with_paths(target_tree)
    if saved_paths != paths:
        saved_set, target_set = set(saved_paths), set(paths)
        only_ckpt = sorted(saved_set - target_set)
        only_target = sorted(target_set - saved_set)
        detail = []
        if only_ckpt:
            detail.append(f"only in checkpoint: {only_ckpt}")
        if only_target:
            detail.append(f"only in target: {only_target}")
        if not detail:
            detail.append("same leaves, different order: "
                          f"{saved_paths} vs {paths}")
        raise ValueError(
            f"checkpoint tree structure does not match the restore "
            f"target ({len(saved_paths)} vs {len(paths)} leaves); "
            + "; ".join(detail))
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(paths))]
    out = []
    for path, tgt, arr in zip(paths, leaves, arrays):
        if hasattr(tgt, "shape") and tuple(tgt.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch at {path!r}: target "
                             f"{tuple(tgt.shape)} vs checkpoint "
                             f"{tuple(arr.shape)}")
        if torch.is_tensor(tgt):
            out.append(torch.as_tensor(arr).to(device=tgt.device,
                                               dtype=tgt.dtype))
        else:
            out.append(np.asarray(arr, dtype=getattr(tgt, "dtype", None)))
    return _unflatten(target_tree, out)


def restore_tree(ckpt_dir: str, step: int | None = None
                 ) -> tuple[dict, dict]:
    """Template-free restore: the saved tree as nested dicts of numpy
    arrays (a bare array comes back bare), and the ``meta`` dict."""
    d = _resolve_step(ckpt_dir, step)
    manifest = _load_manifest(d)
    saved_paths = manifest["paths"]
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(saved_paths))]
    if saved_paths == [""]:
        return arrays[0], manifest.get("meta", {})
    tree: dict = {}
    for path, arr in zip(saved_paths, arrays):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree, manifest.get("meta", {})
