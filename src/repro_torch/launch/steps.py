"""Step builders of the LM trainer and server (port of
``repro.launch.steps``).

``make_train_step``: loss and gradients + the AdamW update, with microbatch
gradient accumulation (``cfg.grad_accum``): batches arrive with a leading
``[accum]`` dim (:func:`add_accum_dim`), each microbatch runs one backward,
and the gradients are summed in f32, as the reference's ``scan`` sums them;
then the loss and the gradients are divided by ``accum``.  The update is
the port's AdamW, in place (``optim/adam.py``).

``make_serve_step`` / ``make_prefill_step``: one decode step (or the prompt)
+ greedy sampling; they return the next token ids, not the logits.
"""
from __future__ import annotations

from typing import Callable

import torch

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


def make_train_step(model: ModelAPI, opt: AdamW) -> Callable:
    accum = max(model.cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        """batch leaves: [accum, B/accum, ...] tensors.  Returns (params,
        opt_state, loss), the first two updated in place."""
        if accum == 1:
            mb = {k: v[0] for k, v in batch.items()}
            loss, grads = value_and_grad(model.loss, params, mb)
        else:
            loss, grads = None, None
            for i in range(accum):
                l, g = value_and_grad(model.loss, params,
                                      {k: v[i] for k, v in batch.items()})
                if grads is None:
                    loss, grads = l.float(), tree_map(lambda x: x.float(), g)
                else:
                    loss = loss + l
                    grads = tree_map(lambda a, x: a + x.float(), grads, g)
            loss = loss / accum
            grads = tree_map(lambda x: x / accum, grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_serve_step(model: ModelAPI) -> Callable:
    def serve_step(params, tokens, state):
        """tokens [B, 1] -> (next_tokens [B, 1] int32, new state)."""
        logits, new_state = model.decode_step(params, tokens, state)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_state

    return serve_step


def make_prefill_step(model: ModelAPI) -> Callable:
    def prefill_step(params, tokens, state):
        """tokens [B, S_prompt] -> (next_tokens [B, 1] int32, filled
        state)."""
        logits, new_state = model.prefill(params, tokens, state)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_state

    return prefill_step


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
