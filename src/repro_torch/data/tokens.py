"""Token data pipeline for the LM trainers (a copy of ``repro.data.tokens``).

* :class:`SyntheticCorpus` — deterministic Zipf-distributed token stream
  (power-law token frequencies: the same access skew GNS exploits on graphs,
  reused by the reference's hot-vocab embedding cache, data/vocab_cache.py).
* :class:`TokenPipeline` — sharded, prefetched host loader:
    - deterministic per-(host, epoch, step) slicing: every host of a 1000-node
      job computes ITS shard of the global batch from the seed alone — no
      data server, no coordination, bit-exact restart from a step index;
    - bounded background prefetch (straggler mitigation: the host pipeline
      runs ahead of the device step, same Prefetcher as the GNN path).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """Zipf token sampler — stands in for a tokenized web corpus."""
    vocab_size: int
    zipf_a: float = 1.2
    seed: int = 0

    def batch(self, epoch: int, step: int, batch: int, seq_len: int,
              host: int = 0, num_hosts: int = 1) -> np.ndarray:
        """[batch/num_hosts, seq_len] int32 — this host's shard, deterministic."""
        assert batch % num_hosts == 0, (batch, num_hosts)
        b_local = batch // num_hosts
        ss = np.random.SeedSequence([self.seed, epoch, step, host])
        rng = np.random.default_rng(ss)
        # inverse-CDF Zipf over a finite vocab (np.random.zipf is unbounded)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        w = ranks ** (-self.zipf_a)
        cdf = np.cumsum(w) / w.sum()
        u = rng.random((b_local, seq_len))
        return np.searchsorted(cdf, u).astype(np.int32)


class TokenPipeline:
    """Prefetched host loader emitting train_step-layout batches.

    Emits dicts of numpy arrays with the leading [accum] microbatch dim
    (launch/steps.py layout).
    """

    def __init__(self, corpus: SyntheticCorpus, batch: int, seq_len: int,
                 accum: int = 1, host: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, extra_builders: Optional[dict] = None):
        assert batch % max(accum, 1) == 0
        self.corpus, self.batch, self.seq_len = corpus, batch, seq_len
        self.accum = max(accum, 1)
        self.host, self.num_hosts = host, num_hosts
        self.prefetch = prefetch
        self.extra_builders = extra_builders or {}

    def _make(self, epoch: int, step: int) -> dict:
        toks = self.corpus.batch(epoch, step, self.batch, self.seq_len,
                                 self.host, self.num_hosts)
        b_local = toks.shape[0]
        out = {"tokens": toks.reshape(self.accum, b_local // self.accum,
                                      self.seq_len)}
        for name, fn in self.extra_builders.items():
            out[name] = fn(epoch, step, self.accum, b_local // self.accum)
        return out

    def epoch(self, epoch: int, steps: int, start_step: int = 0) -> Iterator[dict]:
        """Prefetched iterator over ``steps`` batches (resume at start_step)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for s in range(start_step, steps):
                    q.put(self._make(epoch, s))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
