"""Hot-vocabulary embedding cache: the GNS mechanism applied to LM tables
(port of ``repro.data.vocab_cache``).

Large-vocab archs (gemma 256k, seamless 256k, qwen2 152k) have
Zipf-skewed token access, the same power-law skew GNS exploits through
degree-proportional cache sampling (paper eq. 6).  The mapping:

  graph node               -> vocab token
  node degree              -> token frequency (EMA of observed counts)
  GPU feature cache        -> device hot-row table (the host keeps the full
                              table)
  cache-prioritised sample -> input lookups served from the cache, misses
                              streamed
  eq. (11) p^C             -> inclusion probability of a token in the cache
  eq. (10) 1/p rescale     -> importance-corrected *sampled softmax*
                              negatives

Input embeddings are exact (a lookup, not a sample), so they need no
correction; the paper's importance maths is used where sampling really
happens, the output softmax: :func:`sampled_softmax_loss` takes the cached
rows as negatives and subtracts ``log p^C`` (eq. 11) from their logits.

The host side (frequencies, refresh, batch assembly, hit rate, inclusion
probabilities) is the reference's numpy, under the same
``np.random.default_rng(seed)``, so both packages pick the same slots.
The device side is torch: the cache table lives on ``device`` (None: the
GPU; the reference's ``sharding=``, which no caller passes).  Traffic goes
through the port's :class:`~repro_torch.featurestore.TrafficMeter`:
``refresh`` books the rows it gathers for the cache (``bytes_cache_fill``)
and ``assemble`` the rows it streams (``add_batch``), as the reference
does; ``assemble(..., device=)`` also uploads the batch, in the function
that books it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.featurestore import TrafficMeter

__all__ = ["VocabCacheConfig", "VocabCache", "embed_with_cache",
           "sampled_softmax_loss"]


@dataclasses.dataclass(frozen=True)
class VocabCacheConfig:
    fraction: float = 0.01            # |C| / vocab (paper default 1%)
    period: int = 1                   # refresh every N epochs (paper Table 6)
    strategy: str = "sampled"         # "sampled" (GNS eq. 6) | "topk"
    ema: float = 0.9                  # frequency EMA decay across refreshes

    def size(self, vocab: int) -> int:
        return max(int(vocab * self.fraction), 1)


class VocabCache:
    """Host-resident full embedding table + device-pinned hot rows."""

    def __init__(self, host_table: np.ndarray, cfg: VocabCacheConfig,
                 device=None, seed: int = 0):
        self.host_table = host_table               # [V, d] (never on device)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab, self.dim = host_table.shape
        self.size = cfg.size(self.vocab)
        self.freq = np.ones(self.vocab, np.float64)      # uniform prior
        self._rng = np.random.default_rng(seed)
        self.version = -1
        self.slot_of = np.full(self.vocab, -1, np.int32)
        self.token_ids = np.zeros(self.size, np.int64)
        self.table: Optional[torch.Tensor] = None
        self.probs = self.freq / self.freq.sum()

    # -- frequency tracking (the "degree" analog) ---------------------------
    def observe(self, tokens: np.ndarray):
        counts = np.bincount(tokens.reshape(-1), minlength=self.vocab)
        self.freq = self.cfg.ema * self.freq + (1 - self.cfg.ema) * counts

    # -- refresh (paper §3.2) ------------------------------------------------
    def refresh(self, version: int, meter: Optional[TrafficMeter] = None):
        """Draw the cached tokens (top-k of the frequencies, or a Gumbel
        top-k sample of them) and upload their rows to ``device``."""
        self.probs = self.freq / self.freq.sum()
        if self.cfg.strategy == "topk":
            ids = np.argpartition(self.probs, -self.size)[-self.size:]
        else:                                            # Gumbel top-k sample
            g = -np.log(-np.log(self._rng.random(self.vocab) + 1e-300)
                        + 1e-300)
            keys = np.log(self.probs + 1e-300) + g
            ids = np.argpartition(keys, -self.size)[-self.size:]
        ids = np.sort(ids.astype(np.int64))
        self.token_ids = ids
        self.slot_of = np.full(self.vocab, -1, np.int32)
        self.slot_of[ids] = np.arange(self.size, dtype=np.int32)
        rows = self.host_table[ids]
        self.table = torch.from_numpy(rows).to(self.device)
        self.version = version
        if meter is not None:
            meter.bytes_cache_fill += rows.nbytes

    # -- batch assembly (host side) ------------------------------------------
    def assemble(self, tokens: np.ndarray,
                 meter: Optional[TrafficMeter] = None,
                 device=None) -> dict:
        """Slots + streamed rows for a token batch [...]; exact lookup.

        Streamed rows are deduplicated per batch (the paper's 'distinct
        input nodes', the Table 4 analog): each missing token's row crosses
        the host boundary once per batch, not once per occurrence.  Numpy
        arrays; with ``device``, tensors there (the upload of the rows the
        meter books)."""
        slots = self.slot_of[tokens]                     # [...]: slot or -1
        miss_tokens = np.unique(tokens[slots < 0])
        streamed = self.host_table[miss_tokens]          # [M, d]
        # local index of each miss occurrence into the streamed block
        local = np.searchsorted(miss_tokens, tokens)
        local = np.where(slots < 0, local, 0).astype(np.int32)
        if meter is not None:
            meter.add_batch(int(streamed.nbytes))
        out = {"slots": slots.astype(np.int32),
               "streamed": streamed.astype(np.float32),
               "miss_local": local}
        if device is not None:
            dev = resolve_device(device)
            out = {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
        return out

    def hit_rate(self, tokens: np.ndarray) -> float:
        return float((self.slot_of[tokens] >= 0).mean())

    # -- eq. (11): inclusion probability of a token in the sampled cache ----
    def inclusion_probs(self, token_ids: np.ndarray) -> np.ndarray:
        p = self.probs[token_ids]
        return 1.0 - (1.0 - p) ** self.size


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def embed_with_cache(cache_table: torch.Tensor, batch: dict) -> torch.Tensor:
    """h = where(slot >= 0, cache[slot], streamed[miss_local]): exact.
    ``batch``: :meth:`VocabCache.assemble`'s, as tensors on the table's
    device."""
    slots = batch["slots"].long()
    hit = slots >= 0
    cached = cache_table[slots.clamp(min=0)]
    if batch["streamed"].shape[0] == 0:     # every token a hit: no rows
        return cached                       # to index (the reference raises)
    missed = batch["streamed"][batch["miss_local"].long()]
    return torch.where(hit[..., None], cached, missed)


def sampled_softmax_loss(hidden: torch.Tensor, labels: torch.Tensor,
                         label_rows: torch.Tensor, cache_table: torch.Tensor,
                         cache_inclusion: torch.Tensor) -> torch.Tensor:
    """Sampled softmax with cache negatives + GNS eq. (11) correction.

    hidden [T, d]; labels [T] (unused, as in the reference); label_rows
    [T, d] = unembed rows of the gold tokens; cache_table [C, d] =
    negatives; cache_inclusion [C] = p^C from eq. (11).  Subtracting
    log p^C makes the sampled partition an unbiased estimate of the full
    one (the standard sampled-softmax correction with the GNS inclusion
    probability as the proposal mass)."""
    h32 = hidden.float()
    pos = (h32 * label_rows.float()).sum(dim=-1)                   # [T]
    neg = h32 @ cache_table.float().T                              # [T, C]
    neg = neg - torch.log(cache_inclusion.float().clamp(1e-9, 1.0))[None, :]
    all_logits = torch.cat([pos[:, None], neg], dim=1)
    logz = torch.logsumexp(all_logits, dim=1)
    return (logz - pos).mean()
