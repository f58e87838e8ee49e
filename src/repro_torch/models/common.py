"""Shared LM building blocks: norms, RoPE, init helpers (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the reference.  The
reference draws its initial values from ``jax.random`` keys; those bits
cannot be reproduced in torch, so the init here draws the same
distributions from a ``torch.Generator`` (whose device is where the
parameters land), and parity with the reference goes through
``repro_torch.models.lm_params.params_from_numpy``.

The cross-entropies read the mesh in scope (``launch.sharding.use_mesh``):
a rank's loss is its rows' NLL sum over the whole data-parallel batch's
count, and logits holding this rank's vocab slice take the
vocab-parallel NLL (``launch/collectives.py``).  :func:`rms_norm` takes
a model group when each rank holds a slice of the normalised dim (the
recurrent cells' norms under tensor parallelism).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.collectives import (all_reduce, copy_to, data_group,
                                           group_sum, model_group, vocab_nll)
from repro_torch.models.scan_util import remat_call, tree_map


class _MetaGenerator(torch.Generator):
    """The generator of a ``meta`` init (no generator lives on ``meta``):
    a host generator the draws never read, whose ``device``, which the
    init helpers place their tensors on, is ``meta``."""

    @property
    def device(self):
        return torch.device("meta")


def make_generator(seed: int = 0, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (None: the GPU), seeded; on
    ``meta`` (the dry-run's parameter structs) one that draws nothing."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


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
             eps: float = 1e-6, group=None) -> torch.Tensor:
    """``group``: ``x`` and ``scale`` hold this rank's slice of a feature
    dim that the ranks of ``group`` split evenly, and the mean of squares
    runs over the whole dim (its sum over the group, ``group_sum``)."""
    x32 = x.float()
    if group is None:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        var = group_sum(x32.square().sum(dim=-1, keepdim=True), group) / (
            x.shape[-1] * dist.get_world_size(group))
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


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               vocab: Optional[int]) -> torch.Tensor:
    """Per-token NLL in f32; vocab-parallel (``launch/collectives.py``)
    when the mesh in scope splits the vocab, i.e. ``logits`` holds fewer
    than ``vocab`` columns."""
    group, _, index = model_group()
    if group is not None and vocab is not None and logits.shape[-1] != vocab:
        return vocab_nll(logits, labels, group, index)
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    return logz - gold


def full_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits over the whole vocab: on a mesh whose model axis splits it
    (``logits`` holds this rank's slice), the slices gathered in rank
    order (the serving steps' argmax reads every column)."""
    group = model_group()[0]
    if group is not None and logits.shape[-1] != vocab:
        from repro_torch.launch.collectives import gather
        return gather(logits, group, dim=-1, partial=False)
    return logits


def _dp_count(count: torch.Tensor) -> torch.Tensor:
    """The token count of the whole data-parallel batch: this rank's
    summed over the data group of the mesh in scope (no gradient)."""
    return all_reduce(count.detach(), data_group()[0])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token NLL in f32.  logits [..., V], labels [...] int.

    On a mesh with data parallelism, each rank's value is its rows' NLL
    sum over the whole batch's count, so the ranks' values (and their
    gradients) sum to the batch mean; ``vocab``: the full vocab, which
    says whether ``logits`` is this rank's vocab slice."""
    nll = _token_nll(logits, labels, vocab)
    if data_group()[0] is not None:
        if mask is None:
            count = torch.tensor(float(nll.numel()), device=nll.device)
            return nll.sum() / _dp_count(count)
        mask = mask.float()
        return (nll * mask).sum() / _dp_count(mask.sum()).clamp(min=1.0)
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
               m_b: torch.Tensor, vocab: Optional[int]) -> torch.Tensor:
    logits = h_b @ w                                      # [B,C,V] one block
    return (_token_nll(logits, l_b, vocab) * m_b).sum()


def chunked_unembed_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, chunk: int,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Block-wise unembed + cross-entropy (the reference's fused form).

    h [B,S,d] post-final-norm hiddens; w [d,V] unembedding; labels/mask
    [B,S].  Loops over S-blocks so the [B,S,V] logits never exist at once:
    under autograd each block runs under ``torch.utils.checkpoint`` (the
    port's ``jax.checkpoint``), which keeps only its inputs and recomputes
    its logits in backward.  On a mesh: ``w`` may hold this rank's vocab
    columns of ``vocab`` (vocab-parallel NLL, ``h`` entering through
    ``copy_to``), and the count is the data-parallel batch's, as in
    :func:`cross_entropy`.
    """
    s = h.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    group = model_group()[0]
    if group is not None and vocab is not None and w.shape[-1] != vocab:
        h = copy_to(h, group)
    mask = mask.float()
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        blk = (h[:, lo:lo + chunk], w, labels[:, lo:lo + chunk],
               mask[:, lo:lo + chunk], vocab)
        nll = remat_call(_block_nll, *blk) if grad else _block_nll(*blk)
        tot = tot + nll
        cnt = cnt + blk[3].sum()
    return tot / _dp_count(cnt).clamp(min=1.0)


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
