"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar,
sequential) (port of ``repro.models.xlstm``).

xlstm-125m: 12 blocks, mostly mLSTM with sLSTM at configured indices (the
paper's xLSTM[7:1] ratio).  Both carry O(1) decode state.

mLSTM parallel (train) form, stabilized exponential gating (xLSTM paper,
eq. 19-27): with log-forget cumsums F_t and input gates ĩ_s,

    D[t,s] = F_t - F_s + ĩ_s   (s <= t)
    m_t    = max_s D[t,s]
    W[t,s] = exp(D[t,s] - m_t)
    h_t    = Σ_s W[t,s] (q_t·k_s) v_s / max(|Σ_s W (q·k)|, exp(-m_t))

``cfg.xlstm.chunk`` > 0 that divides S (and is smaller) takes the
chunkwise form instead: [Q,Q] tiles inside a chunk, the decode recurrence
across chunks.  Decode form: matrix memory C [B,H,Dqk,Dv], normalizer n
[B,H,Dqk], running max m [B,H], over the S new tokens.

sLSTM: per-head recurrence with exponential gates and a stabilizer,
sequential by construction: a loop over time, as the reference's
``lax.scan``.

The maxima take ``torch.amax`` / ``torch.maximum``, whose gradients split
evenly among tied entries, as JAX's do.  Decode states are f32 and updated
in place (the dict handed in is the one returned); ``m`` starts at -1e30.

On a mesh's model axis, each cell runs this rank's heads with no
collective inside its recurrence; in decode its state holds those heads
(the state rules put them on ``model`` exactly when they divide it).
mLSTM: ``wq``/``wk``/``wv`` hold whole heads' columns (the reference
constrains q to heads on ``model``),
``w_up`` is whole and its output enters the region through ``copy_to``,
the whole ``w_if``, ``w_o`` and ``norm_scale`` give each rank its heads'
columns (their gradients summed over the group), the norm runs over the
whole ``d_inner`` and ``w_down``'s row block is summed over the group.
sLSTM: ``w_ih``'s head-major ``[d, 4d]`` columns are this rank's heads,
``w_hh`` (whole by its rule) gives them their ``[hd, 4hd]`` blocks, and
the norm and ``w_down`` as the mLSTM's.  Heads that do not divide the
axis (reduced xlstm's 2 on 4 ranks) run the cell whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.collectives import copy_to, head_split, reduce_from
from repro_torch.models.common import dense_init, model_dtype, rms_norm, zeros


def _dims(cfg: ArchConfig):
    x = cfg.xlstm
    d_inner = int(x.proj_factor * cfg.d_model)
    d_qk = int(x.qk_factor * d_inner)
    return d_inner, d_qk, x.num_heads


def _copy_into(state: dict, new: dict) -> dict:
    for k, v in new.items():
        state[k].copy_(v)
    return state


def _heads_view(p: dict, cfg: ArchConfig, shapes: dict) -> tuple:
    """``collectives.head_split`` of a cell (module docstring).  A decode
    state follows the same split: its rule puts the heads on the model
    axis exactly when they divide it."""
    return head_split(p, cfg.xlstm.num_heads, shapes)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_inner, d_qk, nh = _dims(cfg)
    dt = model_dtype(cfg)
    return {
        "w_up": dense_init(gen, d, 2 * d_inner, dt),      # x -> (inner, gate)
        "wq": dense_init(gen, d_inner, d_qk, dt),
        "wk": dense_init(gen, d_inner, d_qk, dt),
        "wv": dense_init(gen, d_inner, d_inner, dt),
        "w_if": dense_init(gen, d_inner, 2 * nh, dt),     # input/forget gates
        "w_o": dense_init(gen, d_inner, d_inner, dt),     # output gate
        "norm_scale": zeros(gen, (d_inner,)),
        "w_down": dense_init(gen, d_inner, d, dt),
    }


def _causal_max(dmat: torch.Tensor, q: int) -> tuple:
    """Mask D[t,s] to s <= t (-inf above) and take its row max."""
    mask = torch.ones((q, q), dtype=torch.bool, device=dmat.device).tril()
    dmat = torch.where(mask, dmat, -torch.inf)
    return dmat, torch.amax(dmat, dim=-1)


def _mlstm_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_inner, d_qk, nh = _dims(cfg)
    return {"w_up": (d, 2 * d_inner), "wq": (d_inner, d_qk),
            "wk": (d_inner, d_qk), "wv": (d_inner, d_inner),
            "w_if": (d_inner, 2 * nh), "w_o": (d_inner, d_inner),
            "norm_scale": (d_inner,), "w_down": (d_inner, d)}


def mlstm_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[dict] = None):
    d_inner, d_qk, nh = _dims(cfg)
    b, s, _ = x.shape
    hq, hv = d_qk // nh, d_inner // nh
    p, group, tp, m = _heads_view(p, cfg, _mlstm_shapes(cfg))
    nh //= tp                                       # this rank's heads
    mine = slice(m * nh * hv, (m + 1) * nh * hv)    # their d_inner columns

    up = copy_to(x @ p["w_up"], group)
    inner, gate = torch.chunk(up, 2, dim=-1)
    q = (inner @ p["wq"]).reshape(b, s, nh, hq).transpose(1, 2)
    k = (inner @ p["wk"]).reshape(b, s, nh, hq).transpose(1, 2)
    v = (inner @ p["wv"]).reshape(b, s, nh, hv).transpose(1, 2)
    w_if = copy_to(p["w_if"], group)[:, 2 * m * nh:2 * (m + 1) * nh]
    gates = (inner @ w_if).float().reshape(b, s, nh, 2)
    i_raw = gates[..., 0].transpose(1, 2)                      # [B,H,S]
    f_raw = gates[..., 1].transpose(1, 2)
    logf = F.logsigmoid(f_raw)
    scale = hq ** -0.5
    q32, k32, v32 = q.float(), k.float(), v.float()

    chunk = cfg.xlstm.chunk
    if state is None:
        if chunk and s > chunk and s % chunk == 0:
            h = _mlstm_chunked(q32 * scale, k32, v32, i_raw, logf, chunk)
        else:
            fcum = torch.cumsum(logf, dim=-1)                  # F_t
            dmat = (fcum[..., :, None] - fcum[..., None, :]
                    + i_raw[..., None, :])
            dmat, m = _causal_max(dmat, s)                     # m [B,H,S]
            w = torch.exp(dmat - m[..., None])
            scores = torch.einsum("bhtd,bhsd->bhts", q32, k32) * scale
            cw = scores * w
            denom = torch.maximum(cw.sum(-1).abs(), torch.exp(-m))
            h = torch.einsum("bhts,bhsv->bhtv", cw, v32)
            h = h / denom[..., None]
        new_state = None
    else:
        # recurrent decode over the s new tokens
        c_mat, n_vec, m_run = (state["c"].float(), state["n"].float(),
                               state["m"].float())
        hs = []
        for t in range(s):
            q_t, k_t, v_t = q32[:, :, t], k32[:, :, t], v32[:, :, t]
            i_t, lf_t = i_raw[:, :, t], logf[:, :, t]
            m_new = torch.maximum(lf_t + m_run, i_t)
            fg = torch.exp(lf_t + m_run - m_new)
            ig = torch.exp(i_t - m_new)
            c_mat = fg[..., None, None] * c_mat + ig[..., None, None] * (
                k_t[..., :, None] * v_t[..., None, :])
            n_vec = fg[..., None] * n_vec + ig[..., None] * k_t
            qs = q_t * scale
            num = torch.matmul(qs[..., None, :], c_mat)[..., 0, :]
            den = torch.maximum((qs * n_vec).sum(-1).abs(),
                                torch.exp(-m_new))
            hs.append(num / den[..., None])
            m_run = m_new
        h = torch.stack(hs, dim=2)                             # [B,H,S,hv]
        new_state = _copy_into(state, {"c": c_mat, "n": n_vec, "m": m_run})

    h = h.transpose(1, 2).reshape(b, s, nh * hv).to(x.dtype)
    w_o = copy_to(p["w_o"], group)[:, mine]
    o = torch.sigmoid((inner @ w_o).float()).to(x.dtype)
    scale = copy_to(p["norm_scale"], group)[mine]
    h = rms_norm(h, scale, group=group) * o * F.silu(gate[..., mine])
    return reduce_from(h @ p["w_down"], group), new_state


def _mlstm_chunked(q, k, v, i_raw, logf, chunk: int):
    """Chunkwise-parallel mLSTM (the reference's TFLA-style form).

    q [B,H,S,dq] (pre-scaled), k/v f32, gates i_raw/logf [B,H,S].  Splits S
    into Q-chunks: intra-chunk the stabilized parallel form on [Q,Q] tiles;
    inter-chunk the matrix memory (C, n, m) carried recurrently, the decode
    recurrence batched per chunk:

      m_t = max(F_t + m0, max_{s<=t} (F_t - F_s + i_s))
      C_t = e^{F_t+m0-m_t} C0 + sum_s e^{F_t-F_s+i_s-m_t} k_s v_s^T
      h_t = [e^{F_t+m0-m_t} (q_t C0) + sum_s W[t,s](q_t k_s) v_s] / denom
      denom = max(|same with n|, e^{-m_t})

    Memory O(S*Q) instead of O(S^2).
    """
    b, h, s, dq = q.shape
    dv = v.shape[-1]
    nc = s // chunk

    def rs(t):
        return t.reshape(*t.shape[:2], nc, chunk, *t.shape[3:])

    qc, kc, vc = rs(q), rs(k), rs(v)                    # [B,H,NC,Q,*]
    ic, fc = rs(i_raw), rs(logf)
    fcum = torch.cumsum(fc, dim=-1)                     # F_t within chunk
    ftot = fcum[..., -1]                                # [B,H,NC]

    # intra-chunk stabilized parallel pieces (per chunk)
    dmat = fcum[..., :, None] - fcum[..., None, :] + ic[..., None, :]
    dmat, m_intra = _causal_max(dmat, chunk)            # [B,H,NC,Q]

    c0 = torch.zeros((b, h, dq, dv), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((b, h, dq), dtype=torch.float32, device=q.device)
    m0 = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        qk, kk, vk = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        fk, ik, dk = fcum[:, :, c], ic[:, :, c], dmat[:, :, c]
        mk, ftk = m_intra[:, :, c], ftot[:, :, c]
        # combined stabilizer: running-max carry vs intra max
        m_t = torch.maximum(fk + m0[..., None], mk)     # [B,H,Q]
        w = torch.exp(dk - m_t[..., None])              # [B,H,Q,Q]
        scores = torch.einsum("bhtd,bhsd->bhts", qk, kk)
        cw = scores * w
        num = torch.einsum("bhts,bhsv->bhtv", cw, vk)
        den = cw.sum(-1)
        carry_scale = torch.exp(fk + m0[..., None] - m_t)  # [B,H,Q]
        num = num + carry_scale[..., None] * torch.einsum(
            "bhtd,bhdv->bhtv", qk, c0)
        den = den + carry_scale * torch.einsum("bhtd,bhd->bht", qk, n0)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # chunk-end carry (t = Q): decay each in-chunk key to the boundary
        m_q = m_t[..., -1]
        dec = torch.exp(ftk[..., None] - fk + ik - m_q[..., None])  # [B,H,Q]
        keep = torch.exp(ftk + m0 - m_q)
        c0 = keep[..., None, None] * c0 + torch.einsum(
            "bhs,bhsd,bhsv->bhdv", dec, kk, vk)
        n0 = keep[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", dec, kk)
        m0 = m_q
    return torch.stack(hs, dim=2).reshape(b, h, s, dv)


def init_mlstm_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    d_inner, d_qk, nh = _dims(cfg)
    hq, hv = d_qk // nh, d_inner // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, nh, hq, hv), **f32),
            "n": torch.zeros((batch, nh, hq), **f32),
            "m": torch.full((batch, nh), -1e30, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    nh = cfg.xlstm.num_heads
    hd = d // nh
    dt = model_dtype(cfg)
    w_ih = dense_init(gen, d, 4 * d, dt)
    w_hh = (torch.randn((nh, hd, 4 * hd), generator=gen, device=gen.device,
                        dtype=torch.float32) * hd ** -0.5).to(dt)
    return {
        # 4 gates (i, f, z, o) from input; block-diagonal recurrent per head
        "w_ih": w_ih,
        "w_hh": w_hh,
        "b_gates": zeros(gen, (4 * d,)),
        "norm_scale": zeros(gen, (d,)),
        "w_down": dense_init(gen, d, d, dt),
    }


def _slstm_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    nh = cfg.xlstm.num_heads
    hd = d // nh
    return {"w_ih": (d, 4 * d), "w_hh": (nh, hd, 4 * hd),
            "b_gates": (4 * d,), "norm_scale": (d,), "w_down": (d, d)}


def slstm_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[dict] = None):
    """Sequential over the S tokens.  Without ``state`` it starts from
    zeros (``m`` -1e30) and returns None; with it, it continues from the
    state and updates it in place.  On a model axis, this rank's heads
    (module docstring)."""
    d = cfg.d_model
    nh = cfg.xlstm.num_heads
    hd = d // nh
    b, s, _ = x.shape
    p, group, tp, r = _heads_view(p, cfg, _slstm_shapes(cfg))
    heads = slice(r * nh // tp, (r + 1) * nh // tp)     # this rank's heads
    nh, d = nh // tp, d // tp
    carry = state if state is not None else {
        k: v[:, heads] for k, v in init_slstm_state(
            cfg, b, device=x.device).items()}

    b_gates = copy_to(p["b_gates"], group)[r * 4 * d:(r + 1) * 4 * d]
    gx = (copy_to(x, group) @ p["w_ih"]).float() + b_gates      # [B,S,4d]
    # head-major inside the loop: the recurrent product and the input
    # gates are one baddbmm per step ([nh, B, 4hd])
    gx = gx.reshape(b, s, nh, 4 * hd).permute(1, 2, 0, 3).contiguous()
    w_hh = copy_to(p["w_hh"], group)[heads].float()
    one = torch.ones((), dtype=torch.float32, device=x.device)  # n == 1 ties
    h, c, n, m = (carry[k].transpose(0, 1) for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(s):
        g = torch.baddbmm(gx[t], h, w_hh)
        i_r, f_r, z_r, o_r = torch.split(g, hd, dim=-1)
        fm = f_r + m
        m_new = torch.maximum(fm, i_r)                          # stabilizer
        ig = torch.exp(i_r - m_new)
        fg = torch.exp(fm - m_new)
        c = torch.addcmul(fg * c, ig, torch.tanh(z_r))
        n = torch.addcmul(ig, fg, n)
        h = torch.sigmoid(o_r) * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    h, c, n, m = (t.transpose(0, 1) for t in (h, c, n, m))     # [B,nh,hd]
    out = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)
    scale = copy_to(p["norm_scale"], group)[heads.start * hd:
                                            heads.stop * hd]
    out = rms_norm(out, scale, group=group)
    new_state = None
    if state is not None:
        new_state = _copy_into(state, {"h": h, "c": c, "n": n, "m": m})
    return reduce_from(out @ p["w_down"], group), new_state


def init_slstm_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    d = cfg.d_model
    nh = cfg.xlstm.num_heads
    hd = d // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hd), **f32),
            "c": torch.zeros((batch, nh, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh, hd), -1e30, **f32)}
