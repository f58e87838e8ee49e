"""Public entry points of the ported kernels.

Dispatch is by device alone, the same for every op: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written CUDA kernel
— or the wrapper raises.  There is no fallback from a CUDA tensor to the
plain version, and no option that selects one.

Gradients follow the reference (``repro.kernels.ops``):

* :func:`cache_lookup_agg` (K1) is a ``torch.autograd.Function`` whose
  backward is the plain-torch port of the reference's hand-written VJP
  (``_fused_bwd``), on both devices: ``dw`` is the lanes' rows against the
  incoming gradient, and the lanes' ``w·g`` are scatter-added into
  ``dcache`` (hits) and ``dstreamed`` (misses).  The reference's backward
  is plain jnp, not Pallas, so no kernel is needed.
* :func:`gather_agg` (K2) has no backward in the reference: ``jax.grad``
  through its Pallas call raises.  Here it raises ``NotImplementedError``
  too, when grad mode is on and an operand requires grad; training runs
  the upper layers through ``aggregate_impl="reference"``.
* :func:`flash_attention` (K4) has no backward in the reference either; it
  raises ``NotImplementedError`` under grad the same way.

**The sharded K1** (``mesh=`` and ``shard_axis=``): one process per mesh
position (:mod:`repro_torch.launch.mesh`).  ``cache_table`` is this rank's
shard of the row-sharded table, the global rows ``[m·rps, (m+1)·rps)`` of
shard ``m``; the batch operands are this rank's data-parallel group's own
(group-local ``idx`` and ``slots``, as inside the reference's
``shard_map`` body).  Three forward paths, as the reference's
``_fused_forward``:

* **psum** — every shard runs its partial
  (:func:`~repro_torch.kernels.cache_lookup.cache_lookup_agg_shard_partial`:
  hits on the shard that owns them, misses on shard 0), then one
  ``all_reduce(SUM)`` over the cache group;
* **static** ``local_shard`` — the host established that every hit lies on
  that shard: its owner runs the ``claim_all`` partial, the other shards
  launch nothing, and the finished rows are broadcast from the owner (the
  reference builds that broadcast as a ppermute tree);
* **per-group** ``local_shards`` (one home shard per data-parallel group,
  -1 for none; the engine's path) — each rank reads its own group's entry:
  with a home shard the owner runs the ``claim_all`` partial and the
  others give exact zeros, without one every shard runs its psum partial;
  then one ``all_reduce``, which returns the owner's rows bitwise (only
  +0.0 terms are added).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                              cache_lookup_agg_plain,
                                              cache_lookup_agg_shard_partial,
                                              shard_lane_weights,
                                              shard_slot_map)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.gather_agg import gather_agg_cuda, gather_agg_plain


def gather_agg(feat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Fused gather + weighted aggregation (K2).  [B, D] f32.  Forward
    only, as the reference's."""
    if torch.is_grad_enabled() and (feat.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "gather_agg (K2) has no backward, as in the reference; train "
            "with ModelConfig(aggregate_impl='reference')")
    if not feat.is_cuda:
        return gather_agg_plain(feat, idx, w)
    return gather_agg_cuda(feat, idx, w)


class PsumClock:
    """Every :func:`psum` that all-reduced: the calls, and the ms each held
    its tensor's stream.  A CPU tensor's is the call's wall time.  A card
    tensor's is the time between two CUDA events on its stream, one
    recorded before the call and one after (gloo stages a card tensor
    through the host and the stream waits for the reduced copy back), read
    once the second has passed: the clock adds no sync to the path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._calls = 0
        self._ms = 0.0
        self._pending: list = []      # (start, end) events not yet read

    def start(self, t: torch.Tensor):
        """The mark taken before ``t``'s all_reduce."""
        if t.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(t.device))
            return ev
        return time.perf_counter()

    def stop(self, t: torch.Tensor, mark) -> None:
        """Count one all_reduce of ``t`` begun at ``mark``."""
        if t.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(t.device))
            with self._lock:
                self._calls += 1
                self._pending.append((mark, ev))
                self._fold(wait=False)
            return
        ms = (time.perf_counter() - mark) * 1e3
        with self._lock:
            self._calls += 1
            self._ms += ms

    def _fold(self, wait: bool) -> None:
        keep = []
        for a, b in self._pending:
            if wait:
                b.synchronize()
            elif not b.query():
                keep.append((a, b))
                continue
            self._ms += a.elapsed_time(b)
        self._pending = keep

    def read(self) -> tuple:
        """``(calls, ms)`` so far (waits for the events still pending)."""
        with self._lock:
            self._fold(wait=True)
            return self._calls, self._ms


psum_clock = PsumClock()


def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``t`` in place over ``mesh``'s ``axis`` group
    (nothing on an axis of one rank; recorded as ``launch/collectives.py``
    records its own, and timed on :data:`psum_clock`); returns ``t``."""
    if mesh.shape[axis] > 1:
        from repro_torch.launch.collectives import record
        record("all-reduce", t.numel() * t.element_size(), mesh.group(axis))
        if not t.is_meta:
            mark = psum_clock.start(t)
            dist.all_reduce(t, group=mesh.group(axis))
            psum_clock.stop(t, mark)
    return t


def dp_axes(mesh, shard_axis) -> tuple:
    """The data-parallel axes of the fused op: the mesh's batch axes minus
    the cache axis (``sharding.batch_axes`` holds the axis-role rule)."""
    from repro_torch.launch.sharding import batch_axes
    return tuple(a for a in batch_axes(mesh) if a != shard_axis)


def dp_group_count(mesh, shard_axis: Optional[str]) -> int:
    """Number of data-parallel groups the fused op's batch operands span:
    the product of the mesh's batch axes minus the cache axis (1 without a
    mesh) — the length a ``local_shards`` home-shard vector must have."""
    if mesh is None:
        return 1
    g = 1
    for a in dp_axes(mesh, shard_axis):
        g *= mesh.shape[a]
    return g


def dp_group_index(mesh, shard_axis) -> int:
    """This rank's data-parallel group (row-major over the dp axes)."""
    g = 0
    for a in dp_axes(mesh, shard_axis):
        g = g * mesh.shape[a] + mesh.index(a)
    return g


def _single(cache_table, streamed, slots, idx, w):
    if not cache_table.is_cuda:
        return cache_lookup_agg_plain(cache_table, streamed, slots, idx, w)
    return cache_lookup_agg_cuda(cache_table, streamed, slots, idx, w)


def _sharded_forward(cache_table, streamed, slots, idx, w, mesh, axis,
                     local_shard, home):
    """The three mesh paths of the module docstring."""
    n, shard = mesh.shape[axis], mesh.index(axis)
    if n == 1:                       # one shard: the table is all there is
        return _single(cache_table, streamed, slots, idx, w)
    rps = cache_table.shape[0]
    if local_shard is not None:
        if shard == local_shard:
            out = cache_lookup_agg_shard_partial(
                cache_table, streamed, slots, idx, w, shard, rps,
                claim_all=True)
        else:
            out = torch.empty((idx.shape[0], cache_table.shape[1]),
                              dtype=torch.float32, device=cache_table.device)
        from repro_torch.launch.collectives import broadcast
        return broadcast(out, mesh.rank_at(axis, local_shard),
                         mesh.group(axis))
    if home is not None and home >= 0:
        # fast: the owner claims every lane; exact zeros elsewhere
        if shard == home:
            part = cache_lookup_agg_shard_partial(
                cache_table, streamed, slots, idx, w, shard, rps,
                claim_all=True)
        else:
            part = torch.zeros((idx.shape[0], cache_table.shape[1]),
                               dtype=torch.float32,
                               device=cache_table.device)
    else:
        part = cache_lookup_agg_shard_partial(cache_table, streamed, slots,
                                              idx, w, shard, rps)
    return psum(part, mesh, axis)


class _CacheLookupAgg(torch.autograd.Function):
    """K1 forward by device (sharded on a mesh); the reference's VJP in
    plain torch."""

    @staticmethod
    def forward(ctx, cache_table, streamed, slots, idx, w, mesh, axis,
                local_shard, home):
        ctx.save_for_backward(cache_table, streamed, slots, idx, w)
        ctx.mesh, ctx.axis = mesh, axis
        if mesh is None:
            return _single(cache_table, streamed, slots, idx, w)
        return _sharded_forward(cache_table, streamed, slots, idx, w, mesh,
                                axis, local_shard, home)

    @staticmethod
    def backward(ctx, g):
        """``local_shard`` and ``local_shards`` are deliberately ignored:
        under the fast path's contract (every hit lane owned by that one
        shard) the owner-claims-its-lanes backward already scatters each
        gradient on the right shard — hits on the home shard because it
        owns them, misses on shard 0 as always — so forward-fast and
        forward-psum share one backward and cannot drift apart.

        On a mesh each rank works on its own group's lanes and its own
        shard: ``dcache`` takes the lanes the shard owns and is summed over
        the data-parallel groups (every group writes the same table),
        ``dw`` is summed over the cache group (each lane's row lives on one
        shard), ``dstreamed`` stays group-local."""
        cache_table, streamed, slots, idx, w = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        need_cache, need_streamed, _, _, need_w = ctx.needs_input_grad[:5]
        g = g.float()
        idx_l = idx.long()
        lane_slots = slots.long()[idx_l]                          # [B, K]
        if mesh is None:
            own = lane_slots >= 0
            rows = lane_slots.clamp(min=0)
            claim = None
        else:
            shard, rps = mesh.index(axis), cache_table.shape[0]
            local = shard_slot_map(lane_slots, shard, rps).long()
            own = local >= 0
            rows = local.clamp(min=0)
            ones = torch.ones_like(w, dtype=torch.float32)
            claim = shard_lane_weights(ones, lane_slots, shard, rps)  # 0/1
        miss = lane_slots < 0
        zero = torch.zeros((), device=g.device)
        dcache = dstreamed = dw = None
        if need_w:
            h0 = torch.where(own[..., None], cache_table[rows].float(),
                             streamed[idx_l].float())             # [B, K, D]
            if claim is not None:
                h0 = h0 * claim[..., None]
            dw = torch.einsum("bd,bkd->bk", g, h0)
            if mesh is not None:
                dw = psum(dw.contiguous(), mesh, axis)
            dw = dw.to(w.dtype)
        if need_cache or need_streamed:
            d = g.shape[1]
            dlane = w.float()[..., None] * g[:, None, :]          # [B, K, D]
            if need_cache:
                dcache = torch.zeros_like(cache_table).index_add_(
                    0, rows.reshape(-1),
                    torch.where(own[..., None], dlane, zero).reshape(-1, d)
                    .to(cache_table.dtype))
                if mesh is not None:
                    for a in dp_axes(mesh, axis):
                        psum(dcache, mesh, a)
            if need_streamed:
                dstreamed = torch.zeros_like(streamed).index_add_(
                    0, idx_l.reshape(-1),
                    torch.where(miss[..., None], dlane, zero).reshape(-1, d)
                    .to(streamed.dtype))
        return dcache, dstreamed, None, None, dw, None, None, None, None


def cache_lookup_agg(cache_table: torch.Tensor, streamed: torch.Tensor,
                     slots: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor, *, mesh=None,
                     shard_axis: Optional[str] = None,
                     local_shard: Optional[int] = None,
                     local_shards=None) -> torch.Tensor:
    """Fused GNS input layer (K1): cache/streamed select + gather-agg.
    [B, D] f32.  Differentiable in ``cache_table``, ``streamed`` and ``w``
    (the reference's VJP, plain torch on both devices).

    With ``mesh`` and ``shard_axis`` it runs the sharded op of the module
    docstring on this rank's shard; ``local_shard`` (an int) selects the
    static fast path, ``local_shards`` (one home shard per data-parallel
    group, -1 for none; the static argument wins) the per-group one.
    Without a cache axis on the mesh both are ignored."""
    if mesh is None or shard_axis not in getattr(mesh, "axis_names", ()):
        mesh = shard_axis = local_shard = local_shards = None
    home = None
    if local_shard is not None:
        n = mesh.shape[shard_axis]
        if not 0 <= int(local_shard) < n:
            raise ValueError(f"local_shard {local_shard} not in [0, {n})")
        local_shard = int(local_shard)
    elif local_shards is not None:
        homes = [int(h) for h in
                 torch.as_tensor(local_shards).reshape(-1).tolist()]
        groups = dp_group_count(mesh, shard_axis)
        if len(homes) != groups:
            raise ValueError(f"local_shards must carry one home shard per "
                             f"data-parallel group ({groups}), got "
                             f"{len(homes)}")
        home = homes[dp_group_index(mesh, shard_axis)]
    return _CacheLookupAgg.apply(cache_table, streamed, slots, idx, w, mesh,
                                 shard_axis, local_shard, home)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention (K4).  q [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh] ->
    q's shape and dtype.  The reference's semantics (``repro.kernels.ops
    .flash_attention``): queries end-aligned to the keys, ``q_offset = Sk -
    Sq`` and ``kv_len = Sk`` from the unpadded lengths.  The reference pads
    Sq and Sk to its blocks; K4 masks its ragged edges itself, so nothing is
    padded here.  Forward only, as the reference's."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention (K4) has no backward, as in the reference; "
            "train with ArchConfig(attn_impl='reference')")
    sq, sk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, window=window, scale=scale, kv_len=sk,
              q_offset=sk - sq)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), **kw)
