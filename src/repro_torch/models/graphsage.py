"""GraphSAGE (mean aggregator) on static padded minibatch blocks
(port of ``repro.models.graphsage``).

Layer ℓ (paper eq. 1/3 with mean aggregator + concat update):

    a_v = Σ_k  w[v,k] · h_src[idx[v,k]]          (weighted neighbor mean)
    h'_v = g(W · [h_v ; a_v] + b)

``aggregate_impl="pallas"`` runs the aggregation through the K2 kernel
(``repro_torch.kernels.ops.gather_agg``); ``"reference"`` is the
reference's own non-kernel path (``repro.models.graphsage
.reference_aggregate``, a gather and an einsum), which its default config
selects.  ``input_impl="fused"`` runs layer 0 through the K1 kernel
(``ops.cache_lookup_agg``): cache lookup and aggregation in one pass, h0
never materialised; ``"where"`` assembles h0 first:

    h0 = where(slot >= 0, cache_table[slot], streamed)

A device-backend batch (``sample_key`` set) with its generation's
``device_adj`` runs layer 0 through ``sampling.kernels.gns_sample_agg``
(K3 on the card): draw, weight and gather on the device.  That aggregate
does not depend on the parameters; its operands are passed detached, the
counterpart of the reference's ``stop_gradient``.

:func:`loss_fn` is the reference's masked log-softmax NLL plus accuracy;
:func:`value_and_grad` differentiates it with respect to the parameters
(``torch.autograd.grad``), the counterpart of ``jax.value_and_grad``.
K2 has no backward (as in the reference), so training uses
``aggregate_impl="reference"``.

The concat-matmul is ``torch.matmul``.  On a CUDA device :func:`forward`
turns TF32 off for matmuls and cuDNN (``torch.backends.cuda.matmul
.allow_tf32 = False``, ``torch.backends.cudnn.allow_tf32 = False``), so
every float32 product keeps full float32 precision, as on the CPU.

Parameters keep the reference's layout, ``{"layers": [{"w": [2·in, out],
"b": [out]}]}``, as a dict of tensors; :func:`params_from_numpy` carries the
reference's parameters over unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.minibatch import DeviceBatch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sampling.kernels import gns_sample_agg


@dataclasses.dataclass(frozen=True)
class SageConfig:
    feat_dim: int
    hidden_dim: int = 256              # paper: 256/512
    num_classes: int = 32
    num_layers: int = 3
    aggregate_impl: str = "reference"  # "reference" | "pallas" (K2 kernel)
    input_impl: str = "where"          # "where" | "fused" (K1 kernel)
    sample_kernel: str = "reference"   # carried as data: the device input
                                       # layer runs K3 on a CUDA device and
                                       # its plain version on the CPU,
                                       # whatever this names


def full_fp32_matmul() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN (process-wide flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_aggregate(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_w: torch.Tensor) -> torch.Tensor:
    """Plain einsum version of the gather + weighted-mean aggregation."""
    gathered = h_src[nbr_idx.long()]                   # [D, K, F]
    return torch.einsum("dk,dkf->df", nbr_w, gathered)


def _get_aggregate(impl: str) -> Callable:
    if impl == "pallas":
        return ops.gather_agg
    return reference_aggregate


def init_params(cfg: SageConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """He-scaled normal weights and zero biases, drawn on the CPU from
    ``generator`` and moved to ``device`` (``None``: the GPU).  The numbers
    differ from the reference's jax.random draw; carry the reference's
    parameters over with :func:`params_from_numpy`."""
    device = resolve_device(device)
    params = {"layers": []}
    in_dim = cfg.feat_dim
    for i in range(cfg.num_layers):
        out_dim = cfg.num_classes if i == cfg.num_layers - 1 else cfg.hidden_dim
        scale = math.sqrt(2.0 / (2 * in_dim))
        w = torch.randn((2 * in_dim, out_dim), generator=generator,
                        dtype=torch.float32) * scale
        b = torch.zeros((out_dim,), dtype=torch.float32)
        params["layers"].append({"w": w.to(device), "b": b.to(device)})
        in_dim = out_dim
    return params


def params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's ``{"layers": [{"w", "b"}]}`` (numpy arrays, e.g.
    ``jax.device_get`` of its params) -> the port's float32 tensors on
    ``device`` (``None``: the GPU)."""
    device = resolve_device(device)

    def tensor(a):        # np.array copies, so the result owns its memory
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {"layers": [{"w": tensor(layer["w"]), "b": tensor(layer["b"])}
                       for layer in tree["layers"]]}


def assemble_input(batch: DeviceBatch, cache_table: torch.Tensor,
                   prefix: Optional[int] = None) -> torch.Tensor:
    """h0 from cache hits + streamed misses (the GNS data path).

    ``prefix`` truncates to the first N rows — the fused input path only
    needs the destination self-rows, not the full padded h0.
    """
    slots = batch.input_cache_slots
    streamed = batch.input_streamed
    mask = batch.input_mask
    if prefix is not None:
        slots, streamed, mask = slots[:prefix], streamed[:prefix], mask[:prefix]
    hit = slots >= 0
    cached_rows = cache_table.index_select(0, slots.clamp(min=0))
    h0 = torch.where(hit[:, None], cached_rows, streamed)
    return h0 * mask[:, None]


def forward(params: dict, batch: DeviceBatch, cache_table: torch.Tensor,
            cfg: SageConfig, device_adj=None) -> torch.Tensor:
    """Returns logits [B_padded, num_classes] on the batch's device.

    ``device_adj`` (the batch's generation's ``DeviceCacheAdj``, paired with
    a device-backend batch that carries ``sample_key``) switches layer 0 to
    the device draw.
    """
    if cache_table.is_cuda:
        full_fp32_matmul()
    agg = _get_aggregate(cfg.aggregate_impl)
    drawn = device_adj is not None and batch.sample_key is not None
    fused = cfg.input_impl == "fused" and not drawn
    h = None if (fused or drawn) else assemble_input(batch, cache_table)
    n_layers = len(batch.blocks)
    for i, (blk, layer) in enumerate(zip(batch.blocks, params["layers"])):
        if i == 0 and drawn:
            a = gns_sample_agg(
                device_adj, cache_table.detach(),
                batch.input_cache_slots, batch.input_fb_rows,
                batch.input_fb_w.detach(), batch.sample_key)
            h_dst = assemble_input(batch, cache_table, prefix=blk.num_dst)
        elif i == 0 and fused:
            a = ops.cache_lookup_agg(cache_table, batch.input_streamed,
                                     batch.input_cache_slots, blk.nbr_idx,
                                     blk.nbr_w)
            h_dst = assemble_input(batch, cache_table, prefix=blk.num_dst)
        else:
            h_dst = h[: blk.num_dst]
            a = agg(h, blk.nbr_idx, blk.nbr_w)
        z = torch.matmul(torch.cat([h_dst, a], dim=-1), layer["w"]) + layer["b"]
        h = torch.relu(z) if i < n_layers - 1 else z
        h = h * blk.dst_mask[:, None]
    return h


def loss_fn(params: dict, batch: DeviceBatch, cache_table: torch.Tensor,
            cfg: SageConfig, device_adj=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked mean log-softmax NLL over ``label_mask``, and accuracy.
    Two f32 scalars on the batch's device."""
    logits = forward(params, batch, cache_table, cfg, device_adj=device_adj)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch.labels.long()
    nll = -logp.gather(1, labels[:, None])[:, 0]
    denom = batch.label_mask.sum().clamp(min=1.0)
    loss = (nll * batch.label_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * batch.label_mask).sum() / denom
    return loss, acc


def value_and_grad(params: dict, batch: DeviceBatch,
                   cache_table: torch.Tensor, cfg: SageConfig,
                   device_adj=None) -> tuple:
    """``(loss, acc, grads)``: :func:`loss_fn` and its gradient with respect
    to every parameter, ``grads`` in the params' layout.  The parameters
    themselves are left as they are (the graph runs over detached leaves
    that share their storage)."""
    leaves = {(i, name): t.detach().requires_grad_(True)
              for i, layer in enumerate(params["layers"])
              for name, t in layer.items()}
    tree = {"layers": [{name: leaves[(i, name)] for name in layer}
                       for i, layer in enumerate(params["layers"])]}
    loss, acc = loss_fn(tree, batch, cache_table, cfg, device_adj=device_adj)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    by_key = dict(zip(leaves, grads))
    gtree = {"layers": [{name: by_key[(i, name)] for name in layer}
                        for i, layer in enumerate(params["layers"])]}
    return loss.detach(), acc.detach(), gtree


def dummy_cache_table(feat_dim: int, device=None) -> torch.Tensor:
    """1-row zero cache for samplers without a device cache (NS), on
    ``device`` (``None``: the GPU)."""
    return torch.zeros((1, feat_dim), dtype=torch.float32,
                       device=resolve_device(device))
