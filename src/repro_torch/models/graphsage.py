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

**On a mesh** (a :class:`~repro_torch.launch.mesh.HostMesh` in scope,
``launch.sharding.use_mesh``, and ``cache_shard_axis`` naming its cache
axis) ``cache_table`` is this rank's shard of the row-sharded table, and
layer 0 routes to the sharded kernels: K1 per shard with its partials
combined (``ops.cache_lookup_agg(mesh=...)``; ``local_shard`` carries the
locality fast path's gate, an int or one home shard per data-parallel
group), or K3 over the shard's row range and an ``all_reduce``.  The rows
read straight from the table (the destinations' own features, or all of
h0 with ``input_impl="where"``) are gathered the same way: each shard
gives the rows it owns (shard 0 the misses), the cache group sums them.
``num_groups`` > 1 is a batch of several data-parallel groups collated
into one (``gns.engine.collate_groups``, the single-process form of the
reference's DP regime): each group's destinations are its own leading
rows (:func:`_dst_rows`), and the device draw runs per group with its own
key.

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

from repro_torch.core.minibatch import DeviceBatch, LayerBlock
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.cache_lookup import shard_slot_map
from repro_torch.launch.sharding import current_mesh
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
    cache_shard_axis: Optional[str] = None
                                       # mesh axis the cache table is row-
                                       # sharded over; with a mesh in scope
                                       # layer 0 runs per shard + all_reduce
    num_groups: int = 1                # DP groups collated into one batch
                                       # (group-order concat, block pads per
                                       # group): dst rows are each group's
                                       # leading rows, not a global prefix


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
                   prefix: Optional[int] = None,
                   rows: Optional[np.ndarray] = None, mesh=None,
                   shard_axis: Optional[str] = None) -> torch.Tensor:
    """h0 from cache hits + streamed misses (the GNS data path).

    ``prefix`` truncates to the first N rows — the fused input path only
    needs the destination self-rows, not the full padded h0.  ``rows`` (an
    index vector) generalises the prefix to non-leading selections: a
    group-collated batch's destination self-rows are each group's leading
    block (:func:`_dst_rows`).  With ``mesh`` (a cache axis of several
    shards), ``cache_table`` is this rank's shard: each shard gives the hit
    rows it owns and shard 0 the misses, and the cache group sums them —
    each row comes from one shard, so the sum is exact.
    """
    slots = batch.input_cache_slots
    streamed = batch.input_streamed
    mask = batch.input_mask
    if rows is not None:
        sel = torch.as_tensor(rows, dtype=torch.long, device=slots.device)
        slots, streamed, mask = (slots.index_select(0, sel),
                                 streamed.index_select(0, sel),
                                 mask.index_select(0, sel))
    elif prefix is not None:
        slots, streamed, mask = slots[:prefix], streamed[:prefix], mask[:prefix]
    if mesh is None or mesh.shape[shard_axis] == 1:
        hit = slots >= 0
        cached_rows = cache_table.index_select(0, slots.clamp(min=0))
        h0 = torch.where(hit[:, None], cached_rows, streamed)
        return h0 * mask[:, None]
    shard = mesh.index(shard_axis)
    local = shard_slot_map(slots, shard, cache_table.shape[0])
    cached_rows = cache_table.index_select(0, local.clamp(min=0))
    other = streamed if shard == 0 else torch.zeros((), device=slots.device)
    h0 = torch.where((local >= 0)[:, None], cached_rows,
                     torch.where((slots < 0)[:, None], other, 0.0))
    return ops.psum((h0 * mask[:, None]).contiguous(), mesh, shard_axis)


def _dst_rows(num_groups: int, blk: LayerBlock) -> Optional[np.ndarray]:
    """Global rows of the destination self-representations, group-collated.

    With one group the destinations are the array's leading ``num_dst`` rows
    (slice, no gather).  A collated batch concatenates G groups' per-group-
    padded arrays, so group g's destinations live at ``g·num_src + [0,
    num_dst)`` of the layer's global source array — a static index vector.
    """
    if num_groups <= 1:
        return None
    return np.concatenate([g * blk.num_src + np.arange(blk.num_dst)
                           for g in range(num_groups)]).astype(np.int32)


def _drawn_layer0(device_adj, cache_table, batch, num_groups, mesh, axis):
    """Layer 0's device draw: per group with its own key when several are
    collated (each group's draw counters are its own rows), sharded on a
    mesh."""
    table = cache_table.detach()
    lanes = (batch.input_cache_slots, batch.input_fb_rows,
             batch.input_fb_w.detach())
    if num_groups <= 1:
        return gns_sample_agg(device_adj, table, *lanes, batch.sample_key,
                              mesh=mesh, shard_axis=axis)
    keys = np.asarray(batch.sample_key).reshape(num_groups, 2)
    chunks = [t.chunk(num_groups) for t in lanes]
    return torch.cat([gns_sample_agg(device_adj, table,
                                     *(c[g] for c in chunks), keys[g:g + 1],
                                     mesh=mesh, shard_axis=axis)
                      for g in range(num_groups)])


def forward(params: dict, batch: DeviceBatch, cache_table: torch.Tensor,
            cfg: SageConfig, device_adj=None, local_shard=None
            ) -> torch.Tensor:
    """Returns logits [B_padded, num_classes] on the batch's device.

    ``device_adj`` (the batch's generation's ``DeviceCacheAdj``, paired with
    a device-backend batch that carries ``sample_key``) switches layer 0 to
    the device draw.  ``local_shard`` is the fused input's locality gate on
    a mesh: an int (static) or one home shard per data-parallel group (-1:
    none), as the reference's.
    """
    if cache_table.is_cuda:
        full_fp32_matmul()
    agg = _get_aggregate(cfg.aggregate_impl)
    mesh, axis = current_mesh(), cfg.cache_shard_axis
    if mesh is None or axis not in mesh.axis_names:
        mesh = axis = None
    drawn = device_adj is not None and batch.sample_key is not None
    fused = cfg.input_impl == "fused" and not drawn
    h = None if (fused or drawn) else assemble_input(
        batch, cache_table, mesh=mesh, shard_axis=axis)
    n_layers = len(batch.blocks)
    for i, (blk, layer) in enumerate(zip(batch.blocks, params["layers"])):
        dst_rows = _dst_rows(cfg.num_groups, blk)
        if i == 0 and (drawn or fused):
            if drawn:
                a = _drawn_layer0(device_adj, cache_table, batch,
                                  cfg.num_groups, mesh, axis)
            else:
                static = local_shard is None or isinstance(
                    local_shard, (int, np.integer))
                a = ops.cache_lookup_agg(
                    cache_table, batch.input_streamed,
                    batch.input_cache_slots, blk.nbr_idx, blk.nbr_w,
                    mesh=mesh, shard_axis=axis,
                    local_shard=local_shard if static else None,
                    local_shards=None if static else local_shard)
            h_dst = assemble_input(batch, cache_table, prefix=blk.num_dst,
                                   rows=dst_rows, mesh=mesh, shard_axis=axis)
        else:
            h_dst = h[: blk.num_dst] if dst_rows is None else h.index_select(
                0, torch.as_tensor(dst_rows, dtype=torch.long,
                                   device=h.device))
            a = agg(h, blk.nbr_idx, blk.nbr_w)
        z = torch.matmul(torch.cat([h_dst, a], dim=-1), layer["w"]) + layer["b"]
        h = torch.relu(z) if i < n_layers - 1 else z
        h = h * blk.dst_mask[:, None]
    return h


def loss_fn(params: dict, batch: DeviceBatch, cache_table: torch.Tensor,
            cfg: SageConfig, device_adj=None, local_shard=None,
            label_count: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked log-softmax NLL and accuracy, each summed over ``label_mask``
    and divided by the label count (at least 1): this batch's, or
    ``label_count`` — the count over every data-parallel group, so that the
    groups' losses sum to the reference's loss over the collated batch.
    Two f32 scalars on the batch's device."""
    logits = forward(params, batch, cache_table, cfg, device_adj=device_adj,
                     local_shard=local_shard)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch.labels.long()
    nll = -logp.gather(1, labels[:, None])[:, 0]
    denom = (batch.label_mask.sum() if label_count is None
             else label_count).clamp(min=1.0)
    loss = (nll * batch.label_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * batch.label_mask).sum() / denom
    return loss, acc


def value_and_grad(params: dict, batch: DeviceBatch,
                   cache_table: torch.Tensor, cfg: SageConfig,
                   device_adj=None, local_shard=None,
                   label_count: Optional[torch.Tensor] = None) -> tuple:
    """``(loss, acc, grads)``: :func:`loss_fn` and its gradient with respect
    to every parameter, ``grads`` in the params' layout.  The parameters
    themselves are left as they are (the graph runs over detached leaves
    that share their storage)."""
    leaves = {(i, name): t.detach().requires_grad_(True)
              for i, layer in enumerate(params["layers"])
              for name, t in layer.items()}
    tree = {"layers": [{name: leaves[(i, name)] for name in layer}
                       for i, layer in enumerate(params["layers"])]}
    loss, acc = loss_fn(tree, batch, cache_table, cfg, device_adj=device_adj,
                        local_shard=local_shard, label_count=label_count)
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
