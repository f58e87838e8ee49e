"""Mamba2 (SSD) block, chunked and matmul-dominant (port of
``repro.models.ssm``).

The zamba2 backbone.  The State-Space Dual form computes, per head h with
scalar decay a_t = exp(dt_t · A_h):

    y_t = C_t · h_t,   h_t = a_t · h_{t-1} + dt_t · B_t ⊗ x_t

Training and the parallel forward take the chunked algorithm (Mamba2 paper
§6): S splits into chunks of Q; inside a chunk a (Q×Q) masked-decay
product, across chunks a loop over per-chunk states [H, N, P], as the
reference's einsums and ``lax.scan``; the decay matrix is masked before
its ``exp`` (:func:`_intra_decay`: the reference's values, and a finite
gradient where the reference's overflows).

Decode (``state`` given) is the recurrent update over the S new tokens on
the [B, H, P, N] state and the conv buffer of the last K-1 inputs.  The
state is written in place: ``state["conv"]`` and ``state["ssd"]`` receive
the new values and the same dict is returned, as the port's KV caches are
(``models/attention.py``).  The buffers are f32; the conv buffer holds the
activation dtype's values, which the reference's state takes after its
first step, so every step reads the reference's values.

On a mesh's model axis, a rank runs its heads: the rule table
splits ``in_proj`` into contiguous column blocks of the concatenated
``[z | x | B | C | dt]``, which do not follow the heads (zamba2's 10,448
columns are 5,224 a rank on 2 ranks: all of z and 104 of x), so each
rank computes its column block's product and the blocks are gathered
(the activations, ``[B, S, 10448]``, not the weight; the gradient summed
over the group and sliced back), and a rank then takes its heads' z, x
and dt and the whole B and C.  ``conv_w`` (its channels split across the
``x | B | C`` boundary in the same way, 4 x 5,248 values) is gathered
whole for use, and a rank convolves its x channels and B and C.
``a_log``, ``ssm_d`` and ``dt_bias`` hold this rank's heads, the gated
norm runs over the whole ``d_inner`` (``rms_norm``'s group),
``out_proj`` holds the heads' rows and its output is summed over the
group.  Heads that do not divide the axis run the block whole on every
rank (every leaf gathered).  Decode on the model axis (serving on a mesh)
runs the same heads: the ``ssd`` state holds this rank's heads (its rule
puts them on ``model`` exactly when they divide it), and the conv state,
split by its rule into contiguous blocks of ``[x | B | C]`` like
``conv_w``, is gathered whole, read as this rank's x channels and all of
B and C, and written back as this rank's block of the whole new state.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.collectives import (copy_to, gather, head_split,
                                           model_group, reduce_from, whole)
from repro_torch.models.common import dense_init, model_dtype, rms_norm, zeros


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def init_ssm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    dt = model_dtype(cfg)
    dev = gen.device
    in_proj = dense_init(gen, d, 2 * d_inner + 2 * s.n_groups * s.d_state
                         + n_heads, dt)
    conv_w = dense_init(gen, s.d_conv, conv_dim, dt, scale=s.d_conv ** -0.5)
    out_proj = dense_init(gen, d_inner, d, dt)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": zeros(gen, (conv_dim,), dt),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "ssm_d": torch.ones((n_heads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((n_heads,), 1e-2,
                                                    **f32))),
        "norm_scale": zeros(gen, (d_inner,)),
        "out_proj": out_proj,
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_inner, d_inner, gn, gn, n_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: [B,S,C]; w: [K,C].  Returns (y,
    new_state): ``state`` is the last K-1 inputs of the previous call,
    ``new_state`` the last K-1 of [state ++ x] (a new tensor, in x's
    dtype)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # [B, S+K-1, C]
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad[:, :0]
    return F.silu(y), new_state


def _leaf_shapes(cfg: ArchConfig) -> dict:
    """The full shape of each leaf of one block (``init_ssm``'s)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.d_state
    conv_dim = d_inner + 2 * gn
    return {"in_proj": (d, 2 * d_inner + 2 * gn + n_heads),
            "conv_w": (s.d_conv, conv_dim), "conv_b": (conv_dim,),
            "a_log": (n_heads,), "ssm_d": (n_heads,), "dt_bias": (n_heads,),
            "norm_scale": (d_inner,), "out_proj": (d_inner, d)}


def _conv_state_in(conv: torch.Tensor, width: int, d_inner: int,
                   mine: slice, heads_local: bool) -> torch.Tensor:
    """The conv state a rank's conv reads, from the state it holds: on a
    model axis the rule splits ``[.., K-1, x | B | C]`` into contiguous
    blocks (gathered whole here), and a head-local rank reads its x
    channels and all of B and C."""
    group = model_group()[0]
    if conv.shape[-1] < width:
        conv = gather(conv, group, dim=-1, partial=False)
    if heads_local:
        conv = torch.cat([conv[..., mine], conv[..., d_inner:]], dim=-1)
    return conv


def _conv_state_out(conv: torch.Tensor, new: torch.Tensor, dl: int,
                    heads_local: bool) -> None:
    """Write the conv's new state back into the state this rank holds:
    a head-local rank's x channels gathered whole first, then this rank's
    block of the rule's split, if it splits."""
    group, tp, m = model_group()
    if heads_local:
        new = torch.cat([gather(new[..., :dl], group, dim=-1, partial=False),
                         new[..., dl:]], dim=-1)
    n = conv.shape[-1]
    if n < new.shape[-1]:
        new = new[..., m * n:(m + 1) * n]
    conv.copy_(new)


def ssm_forward(p: dict, cfg: ArchConfig, x_in: torch.Tensor,
                state: Optional[dict] = None):
    """x_in: [B, S, d].  Returns (y, state | None).

    Train / prefill: state None (chunked SSD).  Decode: state holds
    {"conv": [B,K-1,convdim], "ssd": [B,H,P,N]}, updated in place over the
    S tokens (module docstring).  On a model axis, this rank's heads
    (module docstring)."""
    s_cfg = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    b, seq, _ = x_in.shape
    hd, n = s_cfg.head_dim, s_cfg.d_state
    gn = s_cfg.n_groups * n
    p, group, tp, m = head_split(p, n_heads, _leaf_shapes(cfg))
    hl, dl = n_heads // tp, d_inner // tp          # this rank's heads
    mine = slice(m * dl, (m + 1) * dl)

    width = _leaf_shapes(cfg)["in_proj"][1]
    if p["in_proj"].shape[-1] < width:       # the column-local product
        proj = gather(copy_to(x_in, group) @ p["in_proj"], group, dim=-1,
                      partial=True)
    else:
        proj = copy_to(x_in @ p["in_proj"], group)
    z, x, bb, cc, dt_raw = _split_proj(cfg, proj)
    z, x, dt_raw = z[..., mine], x[..., mine], dt_raw[..., m * hl:
                                                      (m + 1) * hl]
    conv_shape = _leaf_shapes(cfg)["conv_w"]
    conv_w = whole(p["conv_w"], conv_shape, group, partial=True)
    conv_b = whole(p["conv_b"], conv_shape[1:], group, partial=True)
    if tp > 1:                       # this rank's x channels, B and C whole
        conv_w = torch.cat([conv_w[:, mine], conv_w[:, d_inner:]], dim=1)
        conv_b = torch.cat([conv_b[mine], conv_b[d_inner:]])
    conv_in = torch.cat([x, bb, cc], dim=-1)
    conv_state = None
    if state is not None:
        conv_state = _conv_state_in(state["conv"], conv_shape[1], d_inner,
                                    mine, tp > 1)
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_b, conv_state)
    x, bb, cc = torch.split(conv_out, [dl, gn, gn], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])                    # [B,S,H]
    a = -torch.exp(p["a_log"])                                        # [H]
    decay = torch.exp(dt * a)                                         # (0,1)

    xh = x.reshape(b, seq, hl, hd).float()
    # group -> head broadcast (n_groups = 1 for zamba2), this rank's heads
    rep = n_heads // s_cfg.n_groups
    bbh = bb.reshape(b, seq, s_cfg.n_groups, n).repeat_interleave(
        rep, dim=2)[:, :, m * hl:(m + 1) * hl].float()
    cch = cc.reshape(b, seq, s_cfg.n_groups, n).repeat_interleave(
        rep, dim=2)[:, :, m * hl:(m + 1) * hl].float()
    dx = xh * dt[..., None]                                           # dt·x

    if state is not None:
        # recurrent decode: h' = a h + dx ⊗ B ; y = h'·C
        h = state["ssd"].float()                               # [B,H,P,N]
        ys = []
        for t in range(seq):
            h = (h * decay[:, t, :, None, None]
                 + dx[:, t, :, :, None] * bbh[:, t, :, None, :])
            ys.append(torch.matmul(h, cch[:, t, :, :, None])[..., 0])
        y = torch.stack(ys, dim=1)                             # [B,S,H,P]
        y = y + xh * p["ssm_d"][None, None, :, None]
        _conv_state_out(state["conv"], new_conv, dl, tp > 1)
        state["ssd"].copy_(h)
        new_state = state
    else:
        y = _ssd_chunked(decay, bbh, cch, dx, s_cfg.chunk)
        y = y + xh * p["ssm_d"][None, None, :, None]
        new_state = None

    y = y.reshape(b, seq, dl).to(x_in.dtype)
    scale = whole(p["norm_scale"], (d_inner,), group, partial=True)[mine]
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), scale, group=group)
    return reduce_from(y @ p["out_proj"], group), new_state


def _intra_decay(cum: torch.Tensor) -> torch.Tensor:
    """L[t,s] = exp(cum[t] - cum[s]) for s <= t (the decay between s and
    t), 0 above the diagonal.  cum [B,NC,Q,H] -> [B,NC,Q,Q,H].

    The reference takes ``exp`` of every entry and then masks
    (``src/repro/models/ssm.py:160-162``); above the diagonal cum[t] -
    cum[s] is a sum of -log a_r, which overflows ``exp`` once a chunk's
    decay passes e^-88, and the masked inf then makes the gradient NaN
    (0 · inf).  Masking first (-inf, whose ``exp`` is 0) gives the same
    values bit for bit and a finite gradient."""
    q = cum.shape[2]
    lt = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones((q, q), dtype=torch.bool,
                      device=cum.device).tril()[None, None, ..., None]
    return torch.exp(torch.where(mask, lt, -torch.inf))


def _ssd_chunked(decay, bbh, cch, dx, chunk: int):
    """Chunked SSD.  decay [B,S,H]; bbh/cch [B,S,H,N]; dx [B,S,H,P] ->
    [B,S,H,P].  A chunk that does not divide S shrinks until it does."""
    b, s, h = decay.shape
    n = bbh.shape[-1]
    p = dx.shape[-1]
    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q

    def rs(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    decay_c, b_c, c_c, dx_c = rs(decay), rs(bbh), rs(cch), rs(dx)

    logd = torch.log(decay_c.clamp_min(1e-20))                 # [B,NC,Q,H]
    cum = torch.cumsum(logd, dim=2)                      # Σ_{r<=t} log a_r
    total = cum[:, :, -1]                                      # [B,NC,H]

    lmat = _intra_decay(cum)                                   # [B,NC,Q,Q,H]
    scores = torch.einsum("bcthn,bcshn->bctsh", c_c, b_c) * lmat
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, dx_c)

    # chunk-final states: S_c = Σ_s (a_{s+1..Q}) B_s ⊗ dx_s
    decay_after = torch.exp(total[:, :, None, :] - cum)        # [B,NC,Q,H]
    chunk_state = torch.einsum("bcsh,bcshn,bcshp->bchnp",
                               decay_after, b_c, dx_c)         # [B,NC,H,N,P]

    # inter-chunk loop over chunk states; chunk c reads the state before it
    carry = torch.zeros((b, h, n, p), dtype=torch.float32,
                        device=decay.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(total[:, c])[..., None, None] \
            + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [B,NC,H,N,P]

    # inter-chunk contribution: y_t += (a_{1..t}) C_t · h_prev
    decay_into = torch.exp(cum)                                # [B,NC,Q,H]
    y_inter = torch.einsum("bcthn,bchnp->bcthp", c_c, prev_states) \
        * decay_into[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p)


def init_ssm_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    """Zero conv buffer and SSD state (f32; module docstring)."""
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), **f32),
        "ssd": torch.zeros((batch, n_heads, s.head_dim, s.d_state), **f32),
    }
