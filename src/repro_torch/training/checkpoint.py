"""Atomic checkpoints in the reference's on-disk format, the counterpart
of ``repro.training.checkpoint``.

Layout (one directory per step):

    <dir>/step_00000123/
        manifest.json      # tree structure, shapes, dtypes, step, blake2 digests
        arrays.npz         # flattened "path -> array" archive
    <dir>/LATEST           # text file naming the last COMMITTED step dir

Commit protocol: write into ``step_X.tmp``, fsync, rename to ``step_X``,
then rewrite LATEST; restore ignores ``*.tmp``.  npz cannot hold the ML
types, so a bfloat16 or float8 leaf is stored as a same-width unsigned
integer view and its logical dtype named in the manifest, as the
reference stores it; the views are taken with torch, without
``ml_dtypes``.  So a checkpoint written by either package restores in
the other.  Leaves may be tensors (on any device), numpy arrays or
Python scalars; ``restore`` returns tensors on ``device``.

Sharded state (DTensor leaves, ``Trainer(shardings=)``) is saved whole:
each leaf in turn, the ranks send their shards to rank 0, which puts the
full array together on its host (``distributed.fsdp.full_on_rank0``) and
writes the files; the ranks meet at a barrier before ``save`` returns.
``restore(shardings=)`` reads each full array on the host and copies only
this rank's shard of it to ``device`` (a DTensor), a leaf at a time, so
no card holds a whole leaf.  So a checkpoint written on N ranks restores
on one, and in the reference, and the other way round.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.distributed.fsdp import full_on_rank0, shard_tensor

__all__ = ["save", "restore", "latest_step", "list_steps"]

# Logical dtype -> (stored numpy view, a numpy and a torch type of the same
# width that both packages hold, the torch dtype).
_VIEW_DTYPES = {
    "bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, np.uint8, torch.uint8, torch.float8_e5m2),
}
_TORCH_VIEWS = {torch_dtype: name for name, (*_, torch_dtype) in _VIEW_DTYPES.items()}


def _to_savable(v) -> tuple[np.ndarray, str]:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        name = _TORCH_VIEWS.get(t.dtype)
        if name is not None:
            stored, _, torch_view, _ = _VIEW_DTYPES[name]
            return t.contiguous().view(torch_view).numpy().view(stored), name
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(v)
    name = str(a.dtype)
    if name in _VIEW_DTYPES:  # an ml_dtypes array: the same bits
        return a.view(_VIEW_DTYPES[name][0]), name
    return a, name


def _from_savable(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    a = np.array(a)  # an own, writable, C-ordered copy (0-dim stays 0-dim)
    if dtype_name in _VIEW_DTYPES:
        _, same_width, _, torch_dtype = _VIEW_DTYPES[dtype_name]
        return torch.from_numpy(a.view(same_width)).view(torch_dtype).to(device)
    return torch.from_numpy(a).to(device)


_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if tree is None:
        return out  # structural None (e.g. absent fp32 master copy)
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}[{i}]" if prefix else f"[{i}]"))
    else:
        out[prefix] = tree
    return out


def _structure(tree):
    if tree is None:
        return {"__kind__": "none"}
    if isinstance(tree, dict):
        return {"__kind__": "dict", "keys": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(struct, flat, prefix=""):
    kind = struct["__kind__"]
    if kind == "none":
        return None
    if kind == "dict":
        return {
            k: _rebuild(v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k))
            for k, v in struct["keys"].items()
        }
    if kind in ("list", "tuple"):
        items = [
            _rebuild(v, flat, f"{prefix}{_SEP}[{i}]" if prefix else f"[{i}]")
            for i, v in enumerate(struct["items"])
        ]
        return items if kind == "list" else tuple(items)
    return flat[prefix]


def _digest(a: np.ndarray) -> str:
    """blake2b of the array's bytes in C order (the reference's
    ``a.tobytes()``), hashed in place rather than copied."""
    return hashlib.blake2b(np.ascontiguousarray(a).data, digest_size=8).hexdigest()


def save(directory, step: int, state, metadata: dict | None = None, keep: int = 3) -> Path:
    """Atomically write ``state`` (any tree of tensors, arrays or scalars);
    with DTensor leaves, on every rank (rank 0 writes)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    flat = _flatten(state)
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    writer = not sharded or dist.get_rank() == 0
    arrays, dtypes = {}, {}
    for k, v in flat.items():  # the same order on every rank
        if isinstance(v, DTensor):
            v = full_on_rank0(v)
        if writer:
            arrays[k], dtypes[k] = _to_savable(v)
    if writer:
        _write(directory, final, step, state, arrays, dtypes, metadata, keep)
    if sharded:
        dist.barrier()
    return final


def _write(directory, final, step, state, arrays, dtypes, metadata, keep) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "structure": _structure(state),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": dtypes,
        "digests": {k: _digest(a) for k, a in arrays.items()},
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (directory / "LATEST.tmp").write_text(final.name)
    os.replace(directory / "LATEST.tmp", directory / "LATEST")

    for s in list_steps(directory)[:-keep]:  # retention
        shutil.rmtree(directory / f"step_{s:08d}", ignore_errors=True)


def list_steps(directory) -> list[int]:
    directory = Path(directory)
    out = []
    for p in directory.glob("step_*"):
        if p.suffix == ".tmp" or not p.is_dir():
            continue
        try:
            out.append(int(p.name.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(out)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    latest = directory / "LATEST"
    if latest.exists():
        name = latest.read_text().strip()
        if (directory / name).is_dir():
            return int(name.split("_")[1])
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory, step: int | None = None, shardings=None, verify: bool = True, *,
            device=None):
    """Load a checkpoint; returns (state with tensor leaves on ``device``,
    metadata).  Every leaf's digest is checked unless ``verify`` is off.
    ``shardings``: a tree of ``NamedSharding``/None matching the state (or
    None for a whole subtree); each leaf it names becomes this rank's
    shard (elastic reshard), cut on the host."""
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    cuts = _flatten(shardings)
    flat = {}
    with np.load(path / "arrays.npz") as npz:
        for k in npz.files:
            a = npz[k]
            if verify and _digest(a) != manifest["digests"][k]:
                raise IOError(f"checksum mismatch for {k!r} in {path}")
            if k in cuts:
                flat[k] = shard_tensor(_from_savable(a, manifest["dtypes"][k], "cpu"), cuts[k],
                                       dev)
            else:
                flat[k] = _from_savable(a, manifest["dtypes"][k], dev)
    return _rebuild(manifest["structure"], flat), manifest["metadata"]
