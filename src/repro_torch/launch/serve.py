"""Batched decode engine, the LM zoo's serving path (port of
``repro.launch.serve``): the encoder-decoder family, the decoder-only
family (dense, VLM, and MoE with MLA's compressed cache or GQA; a
sliding-window config decodes through its ring cache), the xLSTM family
and the SSM / hybrid family (O(1) recurrent state; zamba2's shared block
also a KV cache per invocation).  An MoE expert's capacity is shared by
the batch's tokens, so a request's tokens depend on the batch it is
served in, as in the reference.

Lockstep batched decoding, as in the reference:

* Requests are grouped into batches of ``max_batch`` by exact prompt
  length (the decode state keeps one position for the whole batch).
* One prefill call (``decode_step`` over the S prompt tokens, which fills
  the KV caches or runs the recurrences over the prompt; an enc-dec model
  first runs its encoder through ``prefill_encoder``), then
  token-by-token greedy (``argmax``) or temperature sampling
  (``torch.multinomial`` with the engine's own ``torch.Generator``);
  per-slot EOS tracking.
* The reference jits one step; PyTorch runs the step eagerly, under
  ``torch.inference_mode``.  Prefill and decode times are taken after
  ``torch.cuda.synchronize()`` on a card.

On a mesh of ranks, :func:`mesh_generate` decodes one batch the same way:
every rank holds its blocks of the parameters (the rule table) and of the
decode state (``launch/specs.py``'s state rules, :func:`mesh_state`) and
runs its rows: head-local caches on the model axis, or, when the batch
does not divide the data axis (B=1), caches whose slots are split over it
(``models/attention.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.lm import ModelAPI, get_model

CACHE_MARGIN = 64                      # cache rows past prompt + new tokens


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray                 # [<=max_new_tokens]
    prefill_s: float
    decode_s: float
    steps: int


class ServeEngine:
    """Serves ``cfg`` with ``params`` (a dict of tensors on ``device``;
    None: the GPU, raising without one)."""

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 8,
                 rng_seed: int = 0, temperature: float = 0.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: ModelAPI = get_model(cfg)
        self.params = params
        self.max_batch = max_batch
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)

    # ------------------------------------------------------------------
    def _step(self, tokens: torch.Tensor, state):
        logits, state = self.model.decode_step(self.params, tokens, state)
        if self.temperature > 0.0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32)[:, None], state

    def _init_state(self, batch: int, cache_len: int, enc_len: int = 0):
        return _decode_init(self.model, batch, cache_len, enc_len,
                            self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def generate_batch(self, requests: Sequence[Request],
                       frame_embeds: Optional[np.ndarray] = None
                       ) -> list[Completion]:
        """All requests must share a prompt length (exact-length batching)."""
        if not requests or len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests for max_batch "
                             f"{self.max_batch}")
        s = len(requests[0].prompt)
        if any(len(r.prompt) != s for r in requests):
            raise ValueError("exact-length batching: group requests by "
                             "prompt length")
        b = len(requests)
        max_new = max(r.max_new_tokens for r in requests)
        cache_len = s + max_new + CACHE_MARGIN
        dev = self.device

        with torch.inference_mode():
            enc_len = frame_embeds.shape[1] if frame_embeds is not None else 0
            state = self._init_state(b, cache_len, enc_len)
            if self.cfg.encoder_layers > 0:
                if frame_embeds is None:
                    raise ValueError("enc-dec serving needs frame_embeds")
                frames = torch.as_tensor(np.asarray(frame_embeds),
                                         device=dev)
                state["cross"] = encdec.prefill_encoder(self.params, self.cfg,
                                                        frames)
            prompts = torch.as_tensor(
                np.stack([r.prompt for r in requests]).astype(np.int32),
                device=dev)

            t0 = time.perf_counter()
            nxt, state = self._step(prompts, state)
            self._sync()
            prefill_s = time.perf_counter() - t0

            out = np.full((b, max_new), -1, np.int32)
            done = np.zeros(b, bool)
            steps = 0
            t0 = time.perf_counter()
            for i in range(max_new):
                cur = nxt[:, 0].cpu().numpy()
                for j, r in enumerate(requests):
                    if not done[j] and i < r.max_new_tokens:
                        out[j, i] = cur[j]
                        if cur[j] == r.eos_id or i + 1 >= r.max_new_tokens:
                            done[j] = True
                steps += 1
                if done.all():
                    break
                nxt, state = self._step(nxt, state)
            self._sync()
            decode_s = time.perf_counter() - t0

        comps = []
        for j, r in enumerate(requests):
            toks = out[j][out[j] >= 0][: r.max_new_tokens]
            comps.append(Completion(tokens=toks, prefill_s=prefill_s,
                                    decode_s=decode_s, steps=steps))
        return comps

    def serve(self, requests: Sequence[Request], **kw) -> list[Completion]:
        """Group by prompt length, batch up to max_batch, run rounds."""
        by_len: dict[int, list[Request]] = {}
        order: dict[int, list[int]] = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.prompt), []).append(r)
            order.setdefault(len(r.prompt), []).append(i)
        results: list[Optional[Completion]] = [None] * len(requests)
        for length, group in by_len.items():
            idxs = order[length]
            for lo in range(0, len(group), self.max_batch):
                chunk = group[lo:lo + self.max_batch]
                comps = self.generate_batch(chunk, **kw)
                for k_i, c in zip(idxs[lo:lo + self.max_batch], comps):
                    results[k_i] = c
        return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# serving on a mesh of ranks
# ---------------------------------------------------------------------------

def _fit(plan, x: torch.Tensor) -> torch.Tensor:
    """``x`` narrowed to ``plan``'s local block along each dim where it is
    still larger (a tree computed from this rank's rows and heads, whose
    other split dims, the slots, it holds whole)."""
    for dim, (n, axes) in enumerate(zip(plan.local_shape, plan.dims)):
        if x.shape[dim] != n:
            x = x.narrow(dim, plan._block(axes) * n, n)
    return x.contiguous()


def _decode_init(model: ModelAPI, batch: int, cache_len: int, enc_len: int,
                 device):
    cfg = model.cfg
    if cfg.encoder_layers > 0:
        return model.decode_init(batch, cache_len, enc_len, device=device)
    if cfg.xlstm is not None:
        return model.decode_init(batch, device=device)
    return model.decode_init(batch, cache_len, device=device)


def mesh_state(cfg: ArchConfig, mesh, batch: int, cache_len: int,
               enc_len: int = 0, device=None) -> tuple:
    """(this rank's initial decode state, its plans): each leaf of the
    state of ``batch`` rows and ``cache_len`` slots at the local shape its
    rule gives it (``launch/specs.py``), filled with the value the
    family's ``decode_init`` starts that leaf at (0; -1 for a ring's
    ``slot_pos``; -1e30 for the sLSTM's stabiliser)."""
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.launch.specs import state_shardings
    model = get_model(cfg)
    structs = _decode_init(model, batch, cache_len, enc_len, "meta")
    plans = state_shardings(mesh, structs)
    fills: dict = {}
    map_with_path(lambda p, x: fills.__setitem__(p, x.flatten()[0].item())
                  if isinstance(x, torch.Tensor) else None,
                  _decode_init(model, 1, 1, 1, "cpu"))
    plan_at: dict = {}
    map_with_path(lambda p, plan: plan_at.__setitem__(p, plan), plans)
    dev = resolve_device(device)

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.full(plan_at[path].local_shape, fills[path],
                          dtype=x.dtype, device=dev)
    return map_with_path(one, structs), plans


@dataclasses.dataclass
class MeshGeneration:
    """What :func:`mesh_generate` returns on a rank."""
    tokens: np.ndarray           # [B_local, new_tokens] int32, greedy
    logits: list                 # per step [B_local, V] f32 (keep_logits)
    state: object                # this rank's final decode state
    layout: dict                 # its launch.sharding.serve_layout
    step_s: list                 # each call's seconds (synchronised)


def mesh_generate(cfg: ArchConfig, params, plans, mesh, prompts,
                  new_tokens: int, *, frame_embeds=None,
                  cache_len: Optional[int] = None, device=None,
                  keep_logits: bool = False, forced=None) -> MeshGeneration:
    """Greedy decoding of one batch on a mesh of ranks, as
    :meth:`ServeEngine.generate_batch` decodes it on one device: every
    rank calls it (in scope of nothing), with its own blocks ``params`` of
    the parameters and their ``plans`` (``lm_params.shard_params``) and
    the whole batch's ``prompts`` [B, S] (and ``frame_embeds`` [B, S_enc,
    d] for an enc-dec model).  Each rank decodes the rows its batch plan
    gives it (all of them when the batch does not divide the data axis:
    the caches then split their slots over it) on ``device`` (None: the
    GPU).  The first call is the prompt's; ``forced`` ([B, new_tokens -
    1], whole batch) feeds those tokens to the later calls instead of the
    greedy ones (teacher forcing: logits comparable step by step with
    another run's)."""
    from repro_torch.launch.sharding import (ShardPlan, map_with_path,
                                            serve_layout, spec_for,
                                            use_mesh)
    from repro_torch.launch.steps import _zero3_full, mesh_layout
    dev = resolve_device(device)
    model = get_model(cfg)
    prompts = np.asarray(prompts, np.int32)
    b, s = prompts.shape
    cache_len = cache_len or s + new_tokens + CACHE_MARGIN
    enc_len = frame_embeds.shape[1] if frame_embeds is not None else 0
    def rows_of(a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a whole-batch [B, ...] array."""
        plan = ShardPlan(mesh, spec_for(mesh, ("batch",) + (None,) * (
            a.ndim - 1), a.shape), a.shape)
        return plan.local(torch.as_tensor(np.ascontiguousarray(a),
                                          device=dev))

    t_plan = ShardPlan(mesh, spec_for(mesh, ("batch", None), (b, s)), (b, s))
    with torch.inference_mode():
        state, s_plans = mesh_state(cfg, mesh, b, cache_len, enc_len, dev)
    layout = mesh_layout(t_plan, s_plans)
    forced = None if forced is None else rows_of(
        np.asarray(forced, np.int32))
    out, logits, step_s = [], [], []
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    with use_mesh(mesh), serve_layout(**layout), torch.inference_mode():
        full = _zero3_full(params, plans)
        if cfg.encoder_layers > 0:
            cross = encdec.prefill_encoder(full, cfg, rows_of(
                np.asarray(frame_embeds)))
            cross_plans: dict = {}
            map_with_path(lambda p, pl: cross_plans.__setitem__(p, pl),
                          s_plans["cross"])
            state["cross"] = {k: _fit(cross_plans[k], v)
                              for k, v in cross.items()}
        nxt = rows_of(prompts)
        for i in range(new_tokens):
            sync()
            t0 = time.perf_counter()
            lg, state = model.decode_step(full, nxt, state)
            sync()
            step_s.append(time.perf_counter() - t0)
            if keep_logits:
                logits.append(lg.float().cpu().numpy())
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            out.append(nxt)
            if forced is not None and i < forced.shape[1]:
                nxt = forced[:, i:i + 1]
    return MeshGeneration(torch.cat(out, dim=1).cpu().numpy(), logits, state,
                          layout, step_s)
