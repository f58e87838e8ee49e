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

Leaves: tensors are written through ``.detach().cpu().numpy()``.  A
bfloat16 tensor is written as the reference writes a bfloat16 leaf: its raw
2-byte patterns as a ``V2`` array, with ``"bfloat16"`` as its manifest
dtype; a leaf whose manifest says ``"bfloat16"`` is read back by viewing
those bytes as ``torch.bfloat16``, so a bf16 checkpoint of either package
loads into the port bit for bit (the reference's own loader hands such a
leaf back as raw ``V2`` bytes).  Any other dtype numpy cannot hold
(float8) raises ``TypeError`` naming the leaf rather than being widened.
A Python int (the AdamW ``step``) is written as an int32 scalar, the
reference's own step dtype; other leaves go through ``np.asarray``.
Loading puts each tensor leaf on ``device`` (``None``: the device of that
leaf of ``tree_like``) and gives a Python int back where ``tree_like``
holds one; other leaves come back as numpy arrays, as the reference's do.

On a mesh of ranks (``plans``: a ``launch.sharding.ShardPlan`` per leaf,
the tree's structure), a save gathers every leaf whole on every rank and
the mesh's leader writes it, so the files are those of one device; a load
reads the whole leaves on every rank and slices each to this rank's block
under the *current* plans: a run saved on one mesh resumes on another, or
on one device (the reference's reshard-on-load).
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
import torch.distributed as dist

from repro_torch.models.scan_util import tree_leaves, tree_map


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


_BF16 = "bfloat16"             # the manifest dtype of a raw 2-byte leaf


def _to_numpy(path: str, x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.detach().view(torch.int16).cpu().numpy().view("V2")
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


def _manifest_dtype(arr: np.ndarray) -> str:
    """A raw 2-byte leaf is a bfloat16 one (the reference's name for it)."""
    return _BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_into(tree_like, flat: dict, dtypes: dict, device=None,
                    prefix: tuple = (), plans=None):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, dtypes, device,
                                   prefix + (str(k),),
                                   None if plans is None else plans[k])
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten_into(v, flat, dtypes, device, prefix + (str(i),),
                            None if plans is None else plans[i])
            for i, v in enumerate(tree_like))
    if tree_like is None:
        return None
    path = "/".join(prefix)
    arr = flat[path]
    want = (plans.shape if plans is not None and isinstance(
        tree_like, torch.Tensor) else tuple(np.shape(tree_like)))
    assert tuple(arr.shape) == want, (path, arr.shape, want)
    if isinstance(tree_like, torch.Tensor):
        dev = device if device is not None else tree_like.device
        t = _tensor(arr, dtypes[path])
        return (t if plans is None else plans.local(t)).to(dev)
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
            "leaves": {k: {"shape": list(v.shape),
                           "dtype": _manifest_dtype(v)}
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
                    device=None, plans=None) -> tuple[Any, int, dict]:
    """Load into the structure of ``tree_like`` (shapes must match), each
    tensor leaf on ``device`` (``None``: where that leaf of ``tree_like``
    lives).  ``plans``: on a mesh, ``tree_like`` holds this rank's blocks
    and each whole leaf is sliced under its plan.  Returns ``(tree, step,
    extra)``."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    assert step is not None, f"no checkpoint under {directory}"
    path = directory / f"step_{step:08d}"
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    dtypes = {k: v["dtype"] for k, v in manifest["leaves"].items()}
    tree = _unflatten_into(tree_like, flat, dtypes, device, plans=plans)
    return tree, manifest["step"], manifest.get("extra", {})


def gather_tree(tree, plans):
    """Every leaf of this rank's ``tree`` gathered whole under its plan
    (a collective: every rank of the mesh calls it, in one order)."""
    return tree_map(lambda plan, x: plan.gather(x), plans, tree)


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

    def maybe_save(self, step: int, tree, extra: Optional[dict] = None,
                   plans=None):
        """Save ``tree`` as step N when N is a multiple of ``every``;
        returns the checkpoint's path (on a mesh, ``plans``: every rank
        gathers, the leader writes, and every rank returns True)."""
        if step % self.every:
            return None
        if plans is None:
            return save_checkpoint(self.directory, step, tree, extra,
                                   keep=self.keep)
        full = gather_tree(tree, plans)
        mesh = tree_leaves(plans)[0].mesh
        if mesh.leader:
            save_checkpoint(self.directory, step, full, extra, keep=self.keep)
        del full
        dist.barrier(group=mesh.host_group)      # written before anyone reads
        return True

    def restore_or_init(self, tree_like, device=None, plans=None):
        """(tree, start_step, extra) — from the newest checkpoint, else
        as-is (``plans``: sliced to this rank's blocks)."""
        if latest_step(self.directory) is None:
            return tree_like, 0, {}
        return load_checkpoint(self.directory, tree_like, device=device,
                               plans=plans)
