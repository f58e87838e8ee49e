"""Step builders of the LM trainer and server (port of
``repro.launch.steps``).

``make_train_step``: loss and gradients + the AdamW update, with microbatch
gradient accumulation (``cfg.grad_accum``): batches arrive with a leading
``[accum]`` dim (:func:`add_accum_dim`), each microbatch runs one backward,
and the gradients are summed in f32, as the reference's ``scan`` sums them;
then the loss and the gradients are divided by ``accum``.  The update is
the port's AdamW, in place (``optim/adam.py``).

On a mesh (``plans``: the ``ShardPlan`` of each local parameter leaf, with
the mesh in scope through ``launch.sharding.use_mesh``), the step is the
data-parallel one: each rank's loss is its rows' share of the batch mean
(``models.common.cross_entropy``), a ZeRO-3 leaf (``cfg.fsdp``) is
gathered over the data group as the loss reads it (its gradient summed
over the group and sliced back, ``launch/collectives.py``), every other
gradient leaf is summed over the data group before the update, and the
loss returned is the batch's, summed over the data group.  The model
axis needs nothing here: the layers' own collectives give every rank the
full gradient of its blocks.

``make_serve_step`` / ``make_prefill_step``: one decode step (or the prompt)
+ greedy sampling; they return the next token ids, not the logits.  On a
mesh (``plans=`` and ``layout=``), each rank runs its blocks: tensor-
parallel heads with head-local caches, caches whose slots are split over
the data axis (B=1), ZeRO-3 leaves gathered (the models' own mesh
branches, ``models/attention.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.launch.collectives import all_reduce, data_group, gather
from repro_torch.launch.sharding import map_with_path, serve_layout
from repro_torch.models.lm import ModelAPI
from repro_torch.models.scan_util import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adam import AdamW


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params`` (each grad in its leaf's dtype).
    ``params`` itself is left as it was (its leaves are read through
    detached aliases)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), tree_unflatten(params, list(grads))


def _zero3_full(params, plans):
    """The parameters as the layers read them: each leaf sharded over the
    data axis (ZeRO-3) gathered along that dim (``gather`` with
    ``partial``: its gradient is summed over the data group, then
    sliced)."""
    group = data_group()[0]

    def one(plan, x):
        for dim, axes in enumerate(plan.dims):
            if "data" in axes:
                x = gather(x, group, dim=dim, partial=True)
        return x
    return tree_map(one, plans, params)


def make_train_step(model: ModelAPI, opt: AdamW, plans=None) -> Callable:
    """``plans``: on a mesh, the local parameter leaves' ``ShardPlan``s
    (module docstring); None: one device."""
    accum = max(model.cfg.grad_accum, 1)
    loss_fn = model.loss
    if plans is not None:
        def loss_fn(params, batch):
            return model.loss(_zero3_full(params, plans), batch)

    def train_step(params, opt_state, batch):
        """batch leaves: [accum, B/accum, ...] tensors.  Returns (params,
        opt_state, loss), the first two updated in place."""
        if accum == 1:
            mb = {k: v[0] for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, params, mb)
        else:
            loss, grads = None, None
            for i in range(accum):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in batch.items()})
                if grads is None:
                    loss, grads = l.float(), tree_map(lambda x: x.float(), g)
                else:
                    loss = loss + l
                    grads = tree_map(lambda a, x: a + x.float(), grads, g)
            loss = loss / accum
            grads = tree_map(lambda x: x / accum, grads)
        if plans is not None:
            group = data_group()[0]
            grads = tree_map(lambda plan, g: g if "data" in plan.axes
                             else all_reduce(g, group), plans, grads)
            loss = all_reduce(loss, group)
        params, opt_state = opt.update(grads, opt_state, params, plans=plans)
        return params, opt_state, loss

    return train_step


def mesh_layout(tokens_plan, state_plans) -> dict:
    """The :func:`~repro_torch.launch.sharding.serve_layout` of a decode
    state's plans on a mesh: whether the tokens' batch leaves the data
    axis free (every data rank then holds the same rows), and whether the
    self-attention caches (``k``/``v``, MLA's ``c_kv``/``k_rope``) and
    the enc-dec ``cross`` K/V split their slot dim over ``data``."""
    found = {"self": False, "cross": False}

    def visit(path, plan):
        leaf = path.split("/")[-1]
        if leaf in ("k", "v", "c_kv", "k_rope") and len(plan.dims) >= 2 \
                and "data" in plan.dims[-2]:
            found["cross" if path.startswith("cross") else "self"] = True
        return plan

    map_with_path(visit, state_plans)
    mesh = tokens_plan.mesh
    replicated = (mesh.shape.get("data", 1) > 1
                  and "data" not in tokens_plan.dims[0])
    return {"replicated_batch": replicated, "self_split": found["self"],
            "cross_split": found["cross"]}


def _serving(fn: Callable, plans, layout) -> Callable:
    """``fn(params, tokens, state)`` on a mesh: ZeRO-3 leaves gathered
    over the data group, under the state's ``serve_layout``."""
    if plans is None and layout is None:
        return fn

    @torch.no_grad()
    def step(params, tokens, state):
        with serve_layout(**(layout or {})):
            if plans is not None:
                params = _zero3_full(params, plans)
            return fn(params, tokens, state)
    return step


def make_serve_step(model: ModelAPI, plans=None,
                    layout: Optional[dict] = None) -> Callable:
    """``plans``: on a mesh (in scope through ``use_mesh``), the local
    parameter leaves' ``ShardPlan``s; ``layout``: :func:`mesh_layout` of
    the state's plans.  Every rank runs the step on its own blocks of the
    parameters, the tokens and the state (``specs.input_specs``'s plans)
    and gets the same next tokens for its rows."""
    def serve_step(params, tokens, state):
        """tokens [B, 1] -> (next_tokens [B, 1] int32, new state)."""
        logits, new_state = model.decode_step(params, tokens, state)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_state

    return _serving(serve_step, plans, layout)


def make_prefill_step(model: ModelAPI, plans=None,
                      layout: Optional[dict] = None) -> Callable:
    """As :func:`make_serve_step`, over the prompt."""
    def prefill_step(params, tokens, state):
        """tokens [B, S_prompt] -> (next_tokens [B, 1] int32, filled
        state)."""
        logits, new_state = model.prefill(params, tokens, state)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_state

    return _serving(prefill_step, plans, layout)


def add_accum_dim(cfg, batch: dict) -> dict:
    """[B, ...] batch leaves (tensors or numpy arrays) -> [accum, B/accum,
    ...] (the train_step layout)."""
    accum = max(cfg.grad_accum, 1)

    def one(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{accum}")
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))

    return tree_map(one, batch)
