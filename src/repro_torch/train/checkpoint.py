"""Fault-tolerant checkpointing: atomic saves, auto-resume, in the JAX
package's on-disk format (``repro.train.checkpoint``).

Layout (one directory per step)::

    <dir>/step_000123/
        manifest.json        # step, leaf names, shapes / dtypes, extra
        arrays_00000.npz     # flattened leaves (chunked to bound file size)
        ...
        COMMITTED            # written LAST -> presence marks validity

Writes go to ``step_X.tmp`` and are ``os.replace``\\ d into place only
after the COMMITTED marker is inside, so a writer dying mid-write leaves
no half-valid checkpoint.  A checkpoint written by either package
restores in the other: the leaves are named by JAX's key paths
(``['params']/['layers']/['attn']/['wk']``, ``['opt']/.m/['embed']/['table']``),
in JAX's order (sorted dict keys, a named tuple's fields in order), a
model's layer stacks stacked as the JAX layout has them, and a bfloat16
leaf is stored as its ``uint16`` bits with ``bfloat16`` in the manifest.
A tree here is a dict, a named tuple (``OptState``), a tensor, or a
model-shaped module tree (the parameters, the moments).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import map_tree, stacked_leaves

__all__ = ["save", "is_valid", "list_steps", "latest_step", "restore",
           "garbage_collect"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_CHUNK_LEAVES = 256


def _flatten(tree, prefix: tuple = ()) -> list:
    """(name parts, stack, tensors) per JAX leaf of ``tree``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, (), [tree])]
    if isinstance(tree, nn.Module):
        return [(prefix + tuple(f"[{k!r}]" for k in keys), stack, tensors)
                for keys, stack, tensors in stacked_leaves(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], prefix + (f"[{k!r}]",))]
    raise TypeError(f"not a checkpointable tree: {type(tree).__name__}")


def _names(flat) -> list[str]:
    return ["/".join(parts) for parts, _, _ in flat]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as its raw bits (npz cannot store it; the
    manifest keeps the logical dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tensor(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically save a tree checkpoint.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    names = _names(flat)
    dtypes = [_dtype_name(ts[0].dtype) for _, _, ts in flat]
    shapes, host = [], []
    for _, stack, tensors in flat:
        arrays = [_host(t) for t in tensors]
        a = (np.stack(arrays).reshape(stack + arrays[0].shape) if stack
             else arrays[0])
        shapes.append(list(a.shape))
        host.append(a)
    files = []
    for c in range(0, len(names), _CHUNK_LEAVES):
        fname = f"arrays_{c // _CHUNK_LEAVES:05d}.npz"
        np.savez(os.path.join(tmp, fname),
                 **{str(i): a for i, a in
                    enumerate(host[c:c + _CHUNK_LEAVES], start=c)})
        files.append(fname)
    manifest = {"step": step, "names": names, "dtypes": dtypes,
                "shapes": shapes, "files": files, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def is_valid(path: str) -> bool:
    return os.path.exists(os.path.join(path, "COMMITTED"))


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and is_valid(os.path.join(directory, d)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _shardings(like, shardings) -> list:
    """The sharding (or None) of each leaf of ``like``, in :func:`_flatten`
    order, from a tree of ``like``'s structure in which a module's place
    holds the JAX layout's dict (``param_shardings`` of its logical axes)
    and any subtree may be None."""
    if shardings is None:
        return [None] * len(_flatten(like))
    if isinstance(like, torch.Tensor):
        return [shardings]
    if isinstance(like, nn.Module):
        def at(keys):
            node = shardings
            for k in keys:
                if node is None:
                    break
                node = node[k]
            return node
        return [at(keys) for keys, _, _ in stacked_leaves(like)]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return [x for f in like._fields
                for x in _shardings(getattr(like, f), getattr(shardings, f))]
    return [x for k in sorted(like) for x in _shardings(like[k],
                                                        shardings[k])]


def _rebuild(like, it, dev: torch.device | None):
    """A tree of ``like``'s structure from the restored leaves ``it``
    yields in :func:`_flatten` order, moved to ``dev`` (``None``: left
    where they are)."""
    def to(t):
        return t if dev is None else t.to(dev)

    if isinstance(like, torch.Tensor):
        return to(next(it))
    if isinstance(like, nn.Module):
        arrays = {tuple(keys): (stack, next(it))
                  for keys, stack, _ in stacked_leaves(like)}

        def leaf(path, p):
            stack, a = arrays[tuple(k for k in path if isinstance(k, str))]
            index = tuple(k for k in path if isinstance(k, int))
            if a.shape != stack + p.shape:
                raise ValueError(f"{'/'.join(map(str, path))}: checkpoint "
                                 f"shape {tuple(a.shape)}, the tree's "
                                 f"{stack + p.shape}")
            return to(a[index] if index else a)
        return map_tree(like, leaf)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), it, dev)
                            for f in like._fields))
    out = {k: _rebuild(like[k], it, dev) for k in sorted(like)}
    return {k: out[k] for k in like}


def restore(directory: str, tree_like, step: int | None = None,
            device: str | torch.device | None = None, shardings=None):
    """Restore into the structure of ``tree_like`` (new tensors and
    modules; a module leaf keeps ``tree_like``'s ``requires_grad``), on
    ``device`` (the card unless the caller asks for the CPU).  Each leaf
    takes the checkpoint's dtype.  Returns (tree, step, extra).

    ``shardings`` (exclusive with ``device``) places the leaves for the
    current mesh, as the JAX ``restore`` does (elastic re-mesh): a tree
    of ``tree_like``'s structure holding a
    :class:`~repro_torch.sharding.partition.NamedSharding` or None per
    leaf.  Each leaf must split as its spec says (``ValueError``
    otherwise, as ``jax.device_put`` raises) and goes, whole, to its
    sharding's home device: the port keeps parameters as global tensors.
    A None leaf goes where the others go (the card when none has one)."""
    if shardings is not None and device is not None:
        raise ValueError("restore takes device or shardings, not both")
    dev = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not is_valid(path):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = _names(_flatten(tree_like))
    if names != manifest["names"]:
        raise ValueError("checkpoint tree structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    arrays: dict[int, np.ndarray] = {}
    for fname in manifest["files"]:
        with np.load(os.path.join(path, fname)) as z:
            for k in z.files:
                arrays[int(k)] = z[k]
    leaves = [_tensor(arrays[i], manifest["dtypes"][i])
              for i in range(len(arrays))]
    if shardings is not None:
        per_leaf = _shardings(tree_like, shardings)
        homes = [s.device for s in per_leaf if s is not None]
        home = homes[0] if homes else resolve_device(None)
        leaves = [a.to(home) if s is None else s.place(a)
                  for a, s in zip(leaves, per_leaf, strict=True)]
    return _rebuild(tree_like, iter(leaves), dev), step, manifest["extra"]


def garbage_collect(directory: str, keep_last: int = 3) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep_last] if keep_last else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    # orphaned tmp dirs from crashed writers
    if os.path.isdir(directory):
        for d in os.listdir(directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)
