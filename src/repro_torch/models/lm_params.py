"""LM parameters between the two packages.

The reference's LM parameters are nested dicts of arrays, stacked on a
leading ``[L, ...]`` axis per layer group.  :func:`params_from_numpy` turns
them, given as numpy arrays (``np.asarray`` of each JAX leaf), into the
port's dict of tensors with the same keys and shapes, so both packages
compute the same thing in the tests: the enc-dec tree, the decoder-only
one with its tied ``embed`` or untied ``embed_in`` / ``unembed`` (MoE and
MLA layers included), and the xLSTM and hybrid trees.  The reference's
AdamW state of such a tree carries over through
:func:`adam_state_from_numpy` (the optimizer's, over any nested tree).

:func:`shard_params` turns a full tree into this rank's local tree on a
mesh of ranks (the rule table of ``launch/sharding.py``); chained after
:func:`params_from_numpy` it is how the reference's parameters reach a
mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import tree_param_shardings
from repro_torch.models.scan_util import tree_map
from repro_torch.optim.adam import adam_state_from_numpy

__all__ = ["params_from_numpy", "adam_state_from_numpy", "shard_params"]


# leaves the reference keeps in f32 in a bf16 model: the SSD's decay,
# skip and step bias (``models/ssm.py``), the sLSTM's gate biases
# (``models/xlstm.py``) and the MoE router (``models/moe.py``); the norm
# scales are matched by "norm" in the path
F32_LEAVES = frozenset({"a_log", "ssm_d", "dt_bias", "b_gates", "router"})


def _keeps_f32(path: str) -> bool:
    return "norm" in path or path.rsplit("/", 1)[-1] in F32_LEAVES


def _leaf_to_torch(path: str, a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: torch cannot view it
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    if dtype is not None and t.is_floating_point() and not _keeps_f32(path):
        t = t.to(dtype)
    return t.to(device)


def _walk(tree, path, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}", fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{path}/{i}", fn)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """Nested dicts (and lists) of numpy arrays -> the same of tensors on
    ``device`` (None: the GPU; raises without one).  ``dtype`` None keeps
    each leaf's type (bfloat16 numpy arrays become ``torch.bfloat16``);
    otherwise every floating leaf but those the reference keeps in float32
    (the norm scales and :data:`F32_LEAVES`) is cast to it."""
    dev = resolve_device(device)
    return _walk(tree, "", lambda path, a: _leaf_to_torch(path, a, dev,
                                                          dtype))



def shard_params(params: dict, mesh, cfg) -> tuple:
    """(this rank's local tree, the tree of its ``ShardPlan``s): each
    leaf of the full tree ``params`` sliced to this rank's block under the
    rule table (``cfg.fsdp``: ZeRO-3 over the data axis).  The local
    leaves are tensors of their own: drop ``params`` to free the full
    tree."""
    plans = tree_param_shardings(mesh, params, fsdp=cfg.fsdp)
    return tree_map(lambda plan, x: plan.local(x), plans, params), plans
