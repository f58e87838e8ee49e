"""Shared LM building blocks: norms, RoPE, init helpers (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the reference.  The
reference draws its initial values from ``jax.random`` keys; those bits
cannot be reproduced in torch, so the init here draws the same
distributions from a ``torch.Generator`` (whose device is where the
parameters land), and parity with the reference goes through
``repro_torch.models.lm_params.params_from_numpy``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.scan_util import tree_map


def make_generator(seed: int = 0, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (None: the GPU), seeded."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _normal(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else (in_dim ** -0.5)
    return (_normal(gen, (in_dim, out_dim)) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    return (_normal(gen, (vocab, dim)) * 0.02).to(dtype)


def zeros(gen: torch.Generator, shape: tuple,
          dtype=torch.float32) -> torch.Tensor:
    """Zeros on the generator's device (norm scales, biases)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, Dh]; positions: broadcastable to [..., S].  Rotates the
    interleaved (even, odd) pairs, as the reference does."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # [Dh/2]
    ang = positions[..., None].float() * freqs               # [..., S, Dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's table; ``jax.nn.gelu`` defaults to the tanh form."""
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "silu": F.silu,
        "swish": F.silu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32.  logits [..., V], labels [...] int."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``custom_vjp`` that casts the cotangent to ``x``'s
    dtype.  Autograd already casts every gradient to the dtype of the
    tensor it flows into, so here it is the identity."""
    return x


def _block_nll(h_b: torch.Tensor, w: torch.Tensor, l_b: torch.Tensor,
               m_b: torch.Tensor) -> torch.Tensor:
    logits = (h_b @ w).float()                            # [B,C,V] one block
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_b[..., None].long())[..., 0]
    return ((logz - gold) * m_b).sum()


def chunked_unembed_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, chunk: int) -> torch.Tensor:
    """Block-wise unembed + cross-entropy (the reference's fused form).

    h [B,S,d] post-final-norm hiddens; w [d,V] unembedding; labels/mask
    [B,S].  Loops over S-blocks so the [B,S,V] logits never exist at once:
    under autograd each block runs under ``torch.utils.checkpoint`` (the
    port's ``jax.checkpoint``), which keeps only its inputs and recomputes
    its logits in backward.
    """
    s = h.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    mask = mask.float()
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        blk = (h[:, lo:lo + chunk], w, labels[:, lo:lo + chunk],
               mask[:, lo:lo + chunk])
        nll = (checkpoint(_block_nll, *blk, use_reentrant=False) if grad
               else _block_nll(*blk))
        tot = tot + nll
        cnt = cnt + blk[3].sum()
    return tot / cnt.clamp(min=1.0)


def stack_init(gen: torch.Generator, n: int, init_fn) -> dict:
    """Initialise n copies of a param tree and stack leaves on axis 0 (the
    reference's layout, so its stacked parameters load as they are).  Each
    copy is written into the preallocated stack as soon as it is drawn, so
    init holds the stack and one layer's tree, never n trees beside their
    stack; a single layer is its own tree, unsqueezed."""
    first = init_fn(gen)
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), first)
    out = tree_map(lambda x: x.new_empty((n, *x.shape)), first)
    tree_map(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, x, i=i: o[i].copy_(x), out, init_fn(gen))
    return out
