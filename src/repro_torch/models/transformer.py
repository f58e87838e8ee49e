"""Token embedding and unembedding (port of ``repro.models.transformer``
``embed_tokens`` / ``unembed``).  The decoder-only LM itself is not ported
yet (``ROADMAP.md`` Queue A item 9)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import rms_norm


def embed_tokens(params: dict, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed_in"] if "embed_in" in params else params["embed"]
    h = table[tokens.long()]
    if cfg.scale_embed:
        h = h * (cfg.d_model ** 0.5)
    return h


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["unembed"]
