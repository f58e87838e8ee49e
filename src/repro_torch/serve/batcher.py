"""Dynamic micro-batching: coalesce queued requests into size buckets.

The batcher only ever emits batches padded to a SMALL FIXED set of sizes
(``ServeConfig.buckets``), so every kernel launch on the serving path sees
one of a few static shapes per bucket.

Coalescing rule: take the oldest queued request, then keep absorbing
requests until either (a) the id budget (the largest bucket) is full,
(b) the batching window ``max_wait_s`` elapses, or (c) waiting any longer
would push the oldest absorbed request past its deadline.  The batch is
then padded up to the smallest bucket that holds its ids.

The batcher also owns the **bounded request queue** — the admission-control
surface: ``offer`` refuses (returns False) when the queue is full, and the
server turns that refusal into a :class:`~repro_torch.serve.server.QueueFull`
rejection instead of letting latency grow without bound.
"""
from __future__ import annotations

import queue
import time
from typing import Optional, Sequence

# close the coalescing window this far BEFORE the earliest deadline in the
# batch: dispatching AT the deadline would expire a request the server had
# every chance to serve (the deadline gates admission-to-batch, so it must
# leave the batcher before the clock runs out)
DEADLINE_MARGIN_S = 0.005


class MicroBatcher:
    """Bounded FIFO of pending requests + the coalescing policy."""

    def __init__(self, buckets: Sequence[int], max_wait_s: float,
                 max_queue: int):
        buckets = tuple(int(b) for b in buckets)
        assert buckets and all(b > 0 for b in buckets), buckets
        assert list(buckets) == sorted(buckets), \
            f"buckets must be ascending: {buckets}"
        self.buckets = buckets
        self.capacity = buckets[-1]          # per-batch id budget
        self.max_wait_s = max_wait_s
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._carry = None    # request pulled but not fitting the last batch

    # ------------------------------------------------------------------
    def offer(self, pending) -> bool:
        """Enqueue; False = queue full (the admission-control refusal)."""
        try:
            self._q.put_nowait(pending)
            return True
        except queue.Full:
            return False

    def qsize(self) -> int:
        return self._q.qsize() + (1 if self._carry is not None else 0)

    def drain(self) -> list:
        """Pull everything queued right now, no coalescing, no waiting
        (the server's cancellation path)."""
        out = []
        if self._carry is not None:
            out.append(self._carry)
            self._carry = None
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def bucket_for(self, n_ids: int) -> int:
        """Smallest bucket holding ``n_ids`` rows."""
        assert 0 < n_ids <= self.capacity, (n_ids, self.capacity)
        for b in self.buckets:
            if n_ids <= b:
                return b
        return self.capacity        # unreachable given the assert

    # ------------------------------------------------------------------
    def next_batch(self, timeout: float) -> Optional[list]:
        """Pull one coalesced batch (FIFO order), or None on idle timeout.

        ``timeout`` bounds only the wait for the FIRST request (the server's
        stop-flag poll interval); once one is in hand, further absorption is
        bounded by the batching window / deadlines / the id budget.
        """
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._q.get(timeout=timeout)
            except queue.Empty:
                return None
        batch = [first]
        total = len(first.node_ids)
        window_end = time.monotonic() + self.max_wait_s
        if first.deadline is not None:
            window_end = min(window_end, first.deadline - DEADLINE_MARGIN_S)
        while total < self.capacity:
            remaining = window_end - time.monotonic()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if total + len(nxt.node_ids) > self.capacity:
                self._carry = nxt        # keep FIFO: lead the next batch
                break
            batch.append(nxt)
            total += len(nxt.node_ids)
            if nxt.deadline is not None:
                window_end = min(window_end,
                                 nxt.deadline - DEADLINE_MARGIN_S)
            # window closed -> the loop keeps absorbing via get_nowait only
            # (drains whatever is already queued, never waits again)
        return batch
