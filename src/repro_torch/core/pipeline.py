"""Sampler pipeline: epoch iteration and background prefetch (port of
``repro.core.pipeline``).

The paper parallelizes sampling so the GPU never waits for the CPU.  Here
a bounded-queue thread prefetches: the numpy sampler releases the GIL in
its hot loops.  With a consumer timeout, a straggling producer is answered
by reusing the previous batch instead of stalling the step (stale caches
are accuracy-neutral, paper Table 6).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from repro_torch.analysis import guarded_by
from repro_torch.core.minibatch import MiniBatch


class EpochLoader:
    """Shuffles targets, drives the sampler's cache lifecycle, yields batches.

    Drop-last semantics (static shapes want full batches).  When the sampler
    sits on a :class:`repro_torch.featurestore.FeatureStore` with an async
    refresh in flight, the loader polls ``swap_if_ready`` between batches:
    a completed shadow generation is published and the sampler adopts it
    before the next ``sample`` call.
    """

    def __init__(self, sampler, train_idx: np.ndarray, seed: int = 0,
                 max_batches: Optional[int] = None, dp_groups: int = 1,
                 group: Optional[int] = None):
        """``dp_groups`` > 1 is the engine's DP regime: batch ``i`` belongs
        to DP group ``i % dp_groups`` (the store's per-group histograms and
        home-shard metering follow), the epoch is truncated to whole group
        rounds, and generation swaps are only polled at round boundaries so
        the ``dp_groups`` batches of one step always share one cache
        generation.  ``group`` (one process per group, the port's mesh)
        yields only that group's batches; the per-batch RNG stays keyed by
        the batch index, so every rank of a group samples the same batch
        and every group the batch the reference's one loader gives it.
        ``None`` yields every group's, in order, as the reference's."""
        self.sampler = sampler
        self.train_idx = np.asarray(train_idx, dtype=np.int64)
        self.seed = seed
        self.max_batches = max_batches
        self.dp_groups = max(int(dp_groups), 1)
        if group is not None and not 0 <= group < self.dp_groups:
            raise ValueError(f"group {group} not in [0, {self.dp_groups})")
        self.group = group

    def _poll_store(self):
        """Swap point: publish a completed shadow generation, then have the
        sampler adopt it before the next ``sample`` call — between batches,
        on the sampling thread, so one batch's slots, weights and adjacency
        all come from one generation."""
        store = getattr(self.sampler, "store", None)
        if store is not None and store.swap_if_ready():
            adopt = getattr(self.sampler, "adopt_generation", None)
            if adopt is not None:
                adopt()

    def epoch(self, epoch: int) -> Iterator[MiniBatch]:
        rng = np.random.default_rng(self.seed + 7919 * epoch)
        self.sampler.start_epoch(epoch, rng)
        b = self.sampler.cfg.batch_size
        perm = rng.permutation(len(self.train_idx))
        n_batches = len(self.train_idx) // b
        if self.max_batches is not None:
            n_batches = min(n_batches, self.max_batches)
        rounded = n_batches - n_batches % self.dp_groups   # whole rounds only
        if n_batches and not rounded:
            raise ValueError(
                f"epoch yields {n_batches} minibatch(es) but dp_groups="
                f"{self.dp_groups} needs at least one full round per step — "
                f"lower batch_size or raise max_batches")
        n_batches = rounded
        store = getattr(self.sampler, "store", None)
        for i in range(n_batches):
            if i % self.dp_groups == 0:
                self._poll_store()
            if self.group is not None and i % self.dp_groups != self.group:
                continue
            if store is not None and self.dp_groups > 1:
                store.dp_group = i % self.dp_groups
            targets = self.train_idx[perm[i * b:(i + 1) * b]]
            # per-batch seeded generator: batch (epoch, i) draws the same
            # sample however the prefetcher thread interleaves with cache
            # refreshes; the epoch rng stays with the permutation and the
            # cache lifecycle
            batch_rng = np.random.default_rng(
                np.random.SeedSequence((self.seed & 0xFFFFFFFF, epoch, i)))
            yield self.sampler.sample(targets, batch_rng)


@guarded_by("_lock", writes_only=("_err",))
class Prefetcher:
    """Bounded-queue background prefetch with a straggler timeout.

    ``wait_s`` accumulates the consumer's time blocked on the queue (the
    sampler-stall metric); with ``meter`` set, the same time lands on
    ``TrafficMeter.t_prefetch_wait``.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator[MiniBatch], depth: int = 2,
                 timeout_s: Optional[float] = None, meter=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._timeout = timeout_s
        self._meter = meter
        self._lock = threading.Lock()   # guards the producer's _err publish
                                        # (the consumer reads it after the
                                        # SENTINEL: queue put/get orders it)
        self._err: Optional[BaseException] = None
        self._last: Optional[MiniBatch] = None
        self.reused = 0                       # straggler-mitigation reuses
        self.wait_s = 0.0                     # consumer time blocked on queue
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            with self._lock:
                self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def _note_wait(self, dt: float):
        self.wait_s += dt
        if self._meter is not None:
            self._meter.t_prefetch_wait += dt

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            try:
                item = self._q.get(timeout=self._timeout)
            except queue.Empty:
                self._note_wait(time.perf_counter() - t0)
                # straggler: reuse the last batch instead of stalling
                if self._last is None:
                    t1 = time.perf_counter()
                    item = self._q.get()      # nothing to reuse yet: block
                    self._note_wait(time.perf_counter() - t1)
                else:
                    self.reused += 1
                    yield self._last
                    continue
            else:
                self._note_wait(time.perf_counter() - t0)
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            self._last = item
            yield item
