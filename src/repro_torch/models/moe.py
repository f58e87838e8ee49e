"""Mixture-of-Experts layer, deepseek-v2 and arctic (port of
``repro.models.moe``).

Dispatch is the reference's capacity-based gather/scatter formulation:

  1. router scores [T, E] in f32, token-choice top-k gate values,
     renormalised;
  2. per expert, ``top_k(C)`` over the token axis selects which tokens the
     expert processes (capacity C = round(T·k/E·cf), at most T); tokens
     beyond capacity are dropped, and an under-subscribed expert fills its
     slots with zero-affinity tokens, which carry weight 0;
  3. gather  x_e = x[idx_e]  -> [E, C, d];
  4. expert FFN as three batched products  [E, C, d] x [E, d, f];
  5. combine back to the tokens with the gate weights.

The combine is deterministic.  The reference scatter-adds the flattened
[E, C] updates into the tokens; ``index_add_`` would do the same on the
card with atomics, whose order varies from run to run.  Here each token's
kept contributions are summed in ascending expert order, the order in
which XLA's CPU scatter and torch's CPU ``index_add_`` apply the
updates: a stable sort of the kept slots by token, a padded [T, k] gather
and k adds.  Filler slots (an expert's zero-affinity tokens) would add
exactly ±0, so they are left out.

deepseek-v2 extras: shared (always-on) experts and a first dense layer;
arctic: a dense FFN residual in parallel with the routed experts.

Only the single-device branch is ported: with a mesh in scope whose
``model`` axis is larger than 1, :func:`moe_forward` raises (expert
parallelism comes with the LM zoo on a mesh, ``ROADMAP.md`` Queue A item
9.8).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import current_mesh
from repro_torch.models.common import activation, dense_init, model_dtype
from repro_torch.models.ffn import ffn_forward, init_ffn


def _experts_init(gen: torch.Generator, e: int, din: int, dout: int,
                  scale: float, dtype) -> torch.Tensor:
    """[e, din, dout] normal * scale in ``dtype``, drawn one expert at a
    time into the stack: no whole-stack f32 temporary (arctic's
    [128, 7168, 4864] stack is 17.8 GB in f32)."""
    out = torch.empty((e, din, dout), dtype=dtype, device=gen.device)
    for i in range(e):
        w = torch.randn((din, dout), generator=gen, device=gen.device,
                        dtype=torch.float32)
        out[i] = w.mul_(scale)
    return out


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    dt = model_dtype(cfg)
    p = {
        "router": dense_init(gen, d, m.num_experts, torch.float32),
        "experts_w1": _experts_init(gen, m.num_experts, d, m.d_expert,
                                    d ** -0.5, dt),
        "experts_w3": _experts_init(gen, m.num_experts, d, m.d_expert,
                                    d ** -0.5, dt),
        "experts_w2": _experts_init(gen, m.num_experts, m.d_expert, d,
                                    m.d_expert ** -0.5, dt),
    }
    if m.num_shared:
        p["shared"] = init_ffn(gen, d, m.d_expert * m.num_shared, True, dt)
    if m.dense_residual:
        p["dense"] = init_ffn(gen, d, cfg.d_ff, True, dt)
    return p


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens (Python's ``round``, as the
    reference's)."""
    m = cfg.moe
    cap = int(max(1, round(t * m.top_k / m.num_experts * m.capacity_factor)))
    return min(cap, t)


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
          num_local_experts: int, expert_offset: int) -> tuple:
    """The reference's routing of ``xt`` [T, d] to the local experts:
    (top_aff [E_loc, C] f32, top_idx [E_loc, C]), each expert's chosen
    tokens and their gate weights (0 on filler slots)."""
    m = cfg.moe
    t = xt.shape[0]
    probs = torch.softmax(xt.float() @ router, dim=-1)             # [T, E]
    gate_vals, gate_idx = torch.topk(probs, m.top_k, dim=-1)       # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # affinity[t, e]: the gate value if e is among t's top-k, else 0 (a
    # token's k experts are distinct, so the scatter adds to zeros only)
    affinity = torch.zeros((t, m.num_experts), dtype=torch.float32,
                           device=xt.device).scatter(1, gate_idx, gate_vals)
    aff_loc = affinity[:, expert_offset:expert_offset + num_local_experts]
    return torch.topk(aff_loc.T, capacity(cfg, t), dim=-1)


def combine(y_e: torch.Tensor, top_aff: torch.Tensor, top_idx: torch.Tensor,
            t: int, k: int) -> torch.Tensor:
    """out[t] = the sum of the kept slots' ``y_e`` [E, C, d] that hold
    token t, in ascending expert order (module docstring); each token is
    kept by at most ``k`` experts."""
    d = y_e.shape[-1]
    kept = (top_aff != 0).reshape(-1)
    n = kept.numel()
    key = torch.where(kept, top_idx.reshape(-1), t)       # t: not kept
    sorted_key, order = torch.sort(key, stable=True)
    tokens = torch.arange(t, device=y_e.device, dtype=sorted_key.dtype)
    start = torch.searchsorted(sorted_key, tokens)
    count = torch.searchsorted(sorted_key, tokens, right=True) - start
    j = torch.arange(k, device=y_e.device)
    valid = j[None, :] < count[:, None]                            # [T, k]
    slot = order[(start[:, None] + j[None, :]).clamp(max=n - 1)]
    vals = y_e.reshape(n, d)[slot]                                 # [T, k, d]
    vals = torch.where(valid[..., None], vals, 0)
    out = torch.zeros((t, d), dtype=y_e.dtype, device=y_e.device)
    for i in range(k):
        out = out + vals[:, i]
    return out


def _routed_experts(xt, router, w1, w3, w2, *, cfg: ArchConfig,
                    num_local_experts: int,
                    expert_offset: int) -> torch.Tensor:
    """Routed experts over ``xt`` [T, d] and the local experts (w1/w3
    [E_loc, d, f], w2 [E_loc, f, d]); the reference's single-device call
    has E_loc = E and offset 0."""
    top_aff, top_idx = route(xt, router, cfg, num_local_experts,
                             expert_offset)
    x_e = xt[top_idx]                                          # [E, C, d]
    act = activation(cfg.ffn_act)
    h = act(torch.bmm(x_e, w1)) * torch.bmm(x_e, w3)
    y_e = torch.bmm(h, w2)                                     # [E, C, d]
    # gate weights are f32; the product goes back to the activation dtype
    y_e = (y_e.float() * top_aff[..., None]).to(xt.dtype)
    return combine(y_e, top_aff, top_idx, xt.shape[0], cfg.moe.top_k)


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d] (the reference's single-device branch)."""
    mesh = current_mesh()
    if (mesh is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1):
        raise NotImplementedError(
            "expert parallelism over a mesh's model axis is not ported yet "
            "(the LM zoo on a mesh, ROADMAP.md Queue A item 9.8)")
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    out = _routed_experts(xt, p["router"], p["experts_w1"], p["experts_w3"],
                          p["experts_w2"], cfg=cfg,
                          num_local_experts=m.num_experts, expert_offset=0)
    if m.num_shared:
        out = out + ffn_forward(p["shared"], cfg.ffn_act, xt, gated=True)
    if m.dense_residual:
        out = out + ffn_forward(p["dense"], cfg.ffn_act, xt, gated=True)
    return out.reshape(b, s, d)


def moe_aux_loss(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f·P)."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xt @ p["router"], dim=-1)
    _, gate_idx = torch.topk(probs, m.top_k, dim=-1)
    frac = torch.nn.functional.one_hot(
        gate_idx, m.num_experts).sum((0, 1)).float() / gate_idx.numel()
    imp = probs.mean(0)
    return m.num_experts * torch.sum(frac * imp)
