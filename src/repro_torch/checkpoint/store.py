"""Checkpoint store (port of ``repro.checkpoint.store``).

* **Atomic**: write to a ``.step_N_*`` tmp dir, fsync, rename — a crash
  mid-write never corrupts the latest checkpoint; a restart picks the
  newest complete one.
* **Self-describing**: a manifest (JSON) stores the leaf paths,
  shapes/dtypes and the step plus a JSON ``extra``.
* **Keep-N**: bounded disk usage under periodic checkpointing.
* **The reference's format**: one ``arrays.npz`` per checkpoint (numpy
  arrays keyed by tree path) + ``manifest.json`` (+ ``aux.npz``).  The
  paths are the ones ``jax.tree_util`` gives the same tree — dict keys by
  name in sorted order, list and tuple items by index, joined by ``/`` —
  so a checkpoint either package writes loads into the other.

Leaves: tensors are written through ``.detach().cpu().numpy()``; a tensor
whose dtype numpy cannot hold (bfloat16, float8) raises ``TypeError``
naming the leaf rather than being widened.  A Python int (the AdamW
``step``) is written as an int32 scalar, the reference's own step dtype;
other leaves go through ``np.asarray``.  Loading puts each tensor leaf on
``device`` (``None``: the device of that leaf of ``tree_like``) and gives
a Python int back where ``tree_like`` holds one; other leaves come back as
numpy arrays, as the reference's do.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _walk(tree, prefix: tuple = ()):
    """(path, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    elif tree is not None:              # None is an empty subtree, as in jax
        yield "/".join(prefix), tree


def _to_numpy(path: str, x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        try:
            return x.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(f"checkpoint leaf {path!r}: numpy cannot hold "
                            f"{x.dtype}") from e
    if isinstance(x, int):
        return np.asarray(np.int32(x))
    return np.asarray(x)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _to_numpy(path, x) for path, x in _walk(tree)}


def _unflatten_into(tree_like, flat: dict, device=None, prefix: tuple = ()):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, device, prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten_into(v, flat, device, prefix + (str(i),))
            for i, v in enumerate(tree_like))
    if tree_like is None:
        return None
    path = "/".join(prefix)
    arr = flat[path]
    assert tuple(arr.shape) == tuple(np.shape(tree_like)), (
        path, arr.shape, np.shape(tree_like))
    if isinstance(tree_like, torch.Tensor):
        dev = device if device is not None else tree_like.device
        return torch.from_numpy(arr).to(dev)
    if isinstance(tree_like, int):
        return int(arr)
    return arr


def _write_npz(path: Path, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str | Path, step: int, tree,
                    extra: Optional[dict] = None, keep: int = 3,
                    aux: Optional[dict] = None) -> Path:
    """Atomically write ``tree`` (+ JSON-serializable ``extra``) as step N.

    ``aux`` is a flat ``{name: array}`` side-payload stored OUTSIDE the tree
    (its own ``aux.npz``): run state whose shapes vary between saves, which
    therefore cannot ride the fixed-shape load path.  Read it back with
    :func:`load_aux`.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    aux = {k: _to_numpy(k, v) for k, v in (aux or {}).items()}

    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=f".step_{step}_"))
    try:
        _write_npz(tmp / "arrays.npz", flat)
        if aux:
            _write_npz(tmp / "aux.npz", aux)
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "aux": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in aux.items()},
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = directory / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int):
    steps = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def load_checkpoint(directory: str | Path, tree_like,
                    step: Optional[int] = None,
                    device=None) -> tuple[Any, int, dict]:
    """Load into the structure of ``tree_like`` (shapes must match), each
    tensor leaf on ``device`` (``None``: where that leaf of ``tree_like``
    lives).  Returns ``(tree, step, extra)``."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    assert step is not None, f"no checkpoint under {directory}"
    path = directory / f"step_{step:08d}"
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_into(tree_like, flat, device)
    return tree, manifest["step"], manifest.get("extra", {})


def load_aux(directory: str | Path, step: Optional[int] = None) -> dict:
    """The ``aux`` side-payload of a checkpoint ({} when none was saved)."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    assert step is not None, f"no checkpoint under {directory}"
    path = directory / f"step_{step:08d}" / "aux.npz"
    if not path.exists():
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class CheckpointManager:
    """Periodic save and restart-resume for the training loops."""

    def __init__(self, directory: str | Path, every: int = 100, keep: int = 3):
        self.directory = Path(directory)
        self.every = max(every, 1)
        self.keep = keep

    def maybe_save(self, step: int, tree, extra: Optional[dict] = None):
        if step % self.every == 0:
            return save_checkpoint(self.directory, step, tree, extra,
                                   keep=self.keep)
        return None

    def restore_or_init(self, tree_like, device=None):
        """(tree, start_step, extra) — from the newest checkpoint, else as-is."""
        if latest_step(self.directory) is None:
            return tree_like, 0, {}
        return load_checkpoint(self.directory, tree_like, device=device)
