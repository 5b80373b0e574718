"""Checkpoints: one ``.npy`` per leaf and a JSON manifest.

A tree is nested dicts (walked in sorted key order, as the JAX
package's tree flattening does), lists, tuples and named tuples (the
optimizer state), ``nn.Module``s (their parameters by sorted name) and
leaves: tensors, numpy arrays, Python numbers.  Leaves are copied to the
host before writing, so a checkpoint does not depend on the device it
came from.  Writes are atomic (a ``.tmp`` directory renamed into place)
and versioned (``step_<n>``); ``latest()`` resolves the newest complete
checkpoint, so a crash during a save never corrupts the restore path.
``save_async`` copies to the host now and writes on a thread.
bf16 leaves are stored as float32 and restored to the template's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn

__all__ = ["save", "save_async", "wait_pending", "restore", "latest"]


def _flatten(tree, path=""):
    """(leaves, description) of ``tree`` in a fixed order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, desc = _flatten(tree[k], f"{path}/{k}")
            leaves += sub
            parts.append(f"{k!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for i, x in enumerate(tree):
            sub, desc = _flatten(x, f"{path}/{i}")
            leaves += sub
            parts.append(desc)
        return leaves, "(" + ", ".join(parts) + ")"
    return [tree], "*"


def _host(x, copy=False):
    """A leaf as a numpy array on the host (bf16 as float32); with
    ``copy``, never one that shares memory with ``x``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=copy).numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """Synchronous atomic checkpoint write; returns its directory."""
    target = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = target + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves, desc = _flatten(tree)
    manifest = {"step": step, "treedef": desc, "n_leaves": len(leaves),
                "extra": extra or {}, "time": time.time()}
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(target):
        shutil.rmtree(target)
    os.rename(tmp, target)
    return target


_pending: list[threading.Thread] = []


def _to_host(tree):
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(x) for x in tree]
    return _host(tree, copy=True)


def save_async(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """The device → host copy happens now; the disk write on a thread."""
    t = threading.Thread(target=save,
                         args=(ckpt_dir, step, _to_host(tree), extra),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in _pending:
        t.join()
    _pending.clear()


def latest(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    if not steps:
        return None
    return os.path.join(ckpt_dir, sorted(steps)[-1])


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _leaf_like(arr, ref, device=None):
    """The stored array as a leaf of ``ref``'s kind and dtype, on
    ``device`` (default ``ref``'s)."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr).to(device=device or ref.device,
                                       dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype)
    return type(ref)(arr.item())


def _rebuild(template, it):
    """``template``'s structure with leaves from ``it``; a module's
    parameters are filled in place, or, where the new leaf lies on
    another device, take its place in the same ``Parameter`` object; the
    module is returned."""
    if isinstance(template, nn.Module):
        params = dict(template.named_parameters())
        with torch.no_grad():
            for k in sorted(params):
                p, new = params[k], next(it)
                if p.device == new.device:
                    p.copy_(new)
                else:
                    torch.utils.swap_tensors(p, nn.Parameter(
                        new, requires_grad=p.requires_grad))
        return template
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(x, it) for x in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, it) for x in template)
    return next(it)


def restore(path: str, template, shardings=None):
    """Restore a checkpoint into ``template``'s structure, each leaf with
    the template leaf's dtype (a module's parameters are overwritten in
    place).  ``shardings``, a tree of ``NamedSharding`` with the
    template's structure (a module's entry a dict by parameter name),
    places each leaf: pass the *new* mesh's to restore onto another
    mesh.  Without it each leaf keeps the template leaf's device.  A
    placement over more than one device raises NotImplementedError
    (``NamedSharding.device``).  Raises ValueError when the leaf count or
    any leaf's shape differs.  Returns (tree, manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(template)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has "
            f"{len(leaves)} — incompatible config")
    if shardings is None:
        devices = [None] * len(leaves)
    else:
        placed, _ = _flatten(shardings)
        if len(placed) != len(leaves):
            raise ValueError(f"{len(placed)} shardings for {len(leaves)} "
                             f"leaves")
        devices = [p.device for p in placed]
    out = []
    for i, (ref, dev) in enumerate(zip(leaves, devices)):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != _shape(ref):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {_shape(ref)}")
        out.append(_leaf_like(arr, ref, dev))
    return _rebuild(template, iter(out)), manifest
