"""Locality-aware cache shard placement (Data Tiering, arXiv:2111.05894).

The plain layout row-partitions the device cache table into *contiguous*
slot blocks:
global slot ``s`` lives on shard ``s // rows_per_shard``.  That layout is
oblivious to *which* data-parallel group actually requests each cached row,
so on the production mesh every fused lookup pays a full psum over the cache
axis even when one shard could have served the whole batch.

This module turns the observed per-DP-group request histograms
(:class:`~repro_torch.featurestore.meter.TrafficMeter`) into an explicit
slot -> (shard, local row) **permutation**:

* each DP group has a *home shard* on the cache axis
  (:func:`home_shard`, ``group % n_shards`` — the device a group's lookups
  can resolve without crossing the cache axis);
* :func:`solve_placement` assigns each cached row to the home shard of the
  group that requests it most — greedy hot-row-first under a hard
  ``rows_per_shard`` capacity per shard, deterministic under ``seed``
  (ties between equal-traffic rows are broken by a seeded shuffle, never by
  dict/argsort incidentals);
* :class:`PlacementMap` carries the resulting permutation both ways
  (``device_row_of_slot`` / ``slot_of_device_row``) so the store can upload
  each generation in device-row order and the fused kernel keeps seeing
  contiguous per-shard blocks — the kernel never learns about placement,
  only the slot values it is handed change.

:func:`identity_placement` reproduces the contiguous blocks exactly
(``device_row == slot``), which is also the fallback whenever no traffic has
been observed yet — so ``CacheConfig(placement="contiguous")`` and a cold
``"locality"`` store are bit-for-bit the contiguous layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def home_shard(group: int, n_shards: int) -> int:
    """Cache-axis shard co-located with DP group ``group``.

    One rule for the solver, the store's locality metering and the trainer's
    fast-path decision — they must agree or "local" lanes would be counted
    against one shard and placed on another.
    """
    return int(group) % max(int(n_shards), 1)


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Bijective slot -> (shard, local row) assignment for one generation.

    ``device_row_of_slot[s] == shard_of_slot[s] * rows_per_shard +
    local_row_of_slot[s]`` and ``slot_of_device_row`` is its inverse — both
    cover the full padded ``table_rows`` range, so every shard holds exactly
    ``rows_per_shard`` rows (padding slots included; padding rows carry zero
    traffic and are never handed to lookups by the store).
    """
    device_row_of_slot: np.ndarray     # int32 [table_rows]  slot -> table row
    slot_of_device_row: np.ndarray     # int32 [table_rows]  table row -> slot
    n_shards: int
    rows_per_shard: int

    @property
    def table_rows(self) -> int:
        return len(self.device_row_of_slot)

    @property
    def is_identity(self) -> bool:
        return bool(
            (self.device_row_of_slot ==
             np.arange(self.table_rows, dtype=np.int32)).all())

    def shard_of_slot(self, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots)
        dev = self.device_rows(slots)
        return np.where(dev >= 0, dev // self.rows_per_shard, -1)

    def local_row_of_slot(self, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots)
        dev = self.device_rows(slots)
        return np.where(dev >= 0, dev % self.rows_per_shard, -1)

    def device_rows(self, slots: np.ndarray) -> np.ndarray:
        """Map logical slots to device-table rows (-1 passes through)."""
        slots = np.asarray(slots)
        safe = np.clip(slots, 0, self.table_rows - 1)
        return np.where(slots >= 0, self.device_row_of_slot[safe],
                        -1).astype(np.int32)


def identity_placement(n_shards: int, table_rows: int) -> PlacementMap:
    """The contiguous blocks as an explicit permutation (the degenerate
    case every placement must decay to when traffic is uninformative)."""
    n_shards = max(int(n_shards), 1)
    assert table_rows % n_shards == 0, (table_rows, n_shards)
    eye = np.arange(table_rows, dtype=np.int32)
    return PlacementMap(device_row_of_slot=eye, slot_of_device_row=eye.copy(),
                        n_shards=n_shards,
                        rows_per_shard=table_rows // n_shards)


def _assign(total: np.ndarray, pref_shard: np.ndarray, n_shards: int,
            rows_per_shard: int,
            seed: int = 0,
            alt_prefs: Optional[np.ndarray] = None,
            pin_shard: Optional[np.ndarray] = None
            ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy hot-row-first capacity assignment.

    Returns ``(shard_of, order)``: the shard index per slot, and the
    traffic-descending visit order it was assigned in (seeded shuffle breaks
    ties) — the caller derives local rows from the SAME order, so the
    tie-break lives in exactly one place.  Each row takes its preferred
    shard while that shard has capacity; rows spilled out of their first
    choice then try their ranked ``alt_prefs`` columns in traffic order
    (``-1`` entries are skipped) — the second-choice spill: a row that
    cannot live with its hottest group's home shard lands with its
    SECOND-hottest group's, capacity permitting, instead of whatever shard
    happens to have free capacity first.  Rows exhausting every ranked
    choice fall back to the remaining capacity in shard order, as before.
    Fully vectorized per pass (the dry-run solves paper-scale |C| ~ 1.1M
    rows; passes are bounded by ``alt_prefs`` columns).

    ``pin_shard`` (incremental re-solve, streaming ingest): rows with a
    non-negative entry claim THAT shard ahead of every preference pass —
    hot-first under the same capacity bound, overflow falls through to the
    normal passes.  ``None`` is bit-for-bit the original solve.
    """
    rows = len(total)
    assert rows == n_shards * rows_per_shard, (rows, n_shards, rows_per_shard)
    rng = np.random.default_rng(seed)
    tiebreak = rng.permutation(rows)
    order = np.lexsort((tiebreak, -np.asarray(total, dtype=np.float64)))

    pref = np.asarray(pref_shard, dtype=np.int64)[order]
    if pin_shard is not None and (np.asarray(pin_shard) >= 0).any():
        # pass 0 — pinned rows (unchanged since the last solve) keep their
        # shard, bounding the migration set to rows that actually changed
        pin = np.asarray(pin_shard, dtype=np.int64)[order]
        shard_ordered = np.full(rows, -1, dtype=np.int64)
        free = np.full(n_shards, rows_per_shard, dtype=np.int64)
        pr = np.where(pin >= 0)[0]
        cand = pin[pr]
        ok = _cumcount(cand, n_shards) < free[cand]
        shard_ordered[pr[ok]] = cand[ok]
        free -= np.bincount(cand[ok], minlength=n_shards)
        # first-choice pass for the remainder, against residual capacity
        un = np.where(shard_ordered < 0)[0]
        cand = pref[un]
        ok = _cumcount(cand, n_shards) < free[cand]
        shard_ordered[un[ok]] = cand[ok]
        free -= np.bincount(cand[ok], minlength=n_shards)
    else:
        # first-choice pass: the i-th row (in traffic order) wanting shard s
        # gets it iff fewer than rows_per_shard hotter rows already claimed s
        rank_in_pref = _cumcount(pref, n_shards)
        got_pref = rank_in_pref < rows_per_shard
        shard_ordered = np.where(got_pref, pref, -1)
        free = rows_per_shard - np.bincount(pref[got_pref],
                                            minlength=n_shards)

    # ranked-alternative passes: unassigned rows (still hot-first) contend
    # for their c-th choice against whatever capacity the earlier passes
    # left.  A choice equal to an already-full shard simply fails again.
    if alt_prefs is not None and len(alt_prefs):
        alts = np.asarray(alt_prefs, dtype=np.int64)[order]
        for c in range(alts.shape[1]):
            un = np.where((shard_ordered < 0) & (alts[:, c] >= 0))[0]
            if not len(un) or not free.any():
                break
            cand = alts[un, c]
            rank = _cumcount(cand, n_shards)
            ok = rank < free[cand]
            shard_ordered[un[ok]] = cand[ok]
            free -= np.bincount(cand[ok], minlength=n_shards)

    # final spill: leftover rows fill the remaining capacity shard-by-shard
    # in shard order — deterministic, and by construction the coldest
    # contenders for every shard they wanted
    un = shard_ordered < 0
    spill_slots = np.repeat(np.arange(n_shards), free)
    shard_ordered[un] = spill_slots
    shard_of = np.empty(rows, dtype=np.int64)
    shard_of[order] = shard_ordered
    return shard_of, order


def _cumcount(values: np.ndarray, n_values: int) -> np.ndarray:
    """Per-element running count of prior occurrences of the same value."""
    counts = np.zeros(len(values), dtype=np.int64)
    for v in range(n_values):
        m = values == v
        counts[m] = np.arange(int(m.sum()))
    return counts


def solve_placement(group_traffic: np.ndarray,
                    n_shards: int, rows_per_shard: int, *,
                    group_ids: Optional[Sequence[int]] = None,
                    seed: int = 0,
                    pin_shard: Optional[np.ndarray] = None) -> PlacementMap:
    """Balanced locality assignment from per-group slot request counts.

    Args:
      group_traffic: [n_groups, table_rows] request counts per (DP group,
        logical slot).  Padding slots must carry zero counts.
      n_shards / rows_per_shard: the device-table layout being filled.
      group_ids: actual DP group indices per histogram row (defaults to
        ``range(n_groups)``); a group's home shard is ``home_shard(g)``.
      seed: tie-break determinism (equal-traffic rows).

    Every slot's preferred shard is the home shard of the group that
    requests it most (ties -> lowest group id); a slot spilled out of its
    first choice tries the home shards of its remaining groups in traffic
    order (second-hottest first, zero-traffic groups never count as a
    choice) before falling back to first-free-in-shard-order — so overflow
    rows still land where SOME of their demand lives.  The greedy
    assignment is capacity-bounded so each shard ends with exactly
    ``rows_per_shard`` rows.  All-zero histograms decay to
    :func:`identity_placement`.

    ``pin_shard`` (int [table_rows], ``-1`` = free) pre-claims shards for
    unchanged rows — see :func:`solve_placement_incremental`.
    """
    traffic = np.asarray(group_traffic, dtype=np.float64)
    assert traffic.ndim == 2, traffic.shape
    n_groups, rows = traffic.shape
    assert rows == n_shards * rows_per_shard, (traffic.shape, n_shards,
                                               rows_per_shard)
    total = traffic.sum(axis=0)
    if n_groups == 0 or not (total > 0).any():
        return identity_placement(n_shards, rows)
    if group_ids is None:
        group_ids = np.arange(n_groups)
    homes = np.array([home_shard(g, n_shards) for g in group_ids],
                     dtype=np.int64)
    pref = homes[np.argmax(traffic, axis=0)]
    alt_prefs = None
    if n_groups > 1:
        # ranked alternatives: each row's remaining groups hottest-first
        # (stable sort -> ties break toward the lowest group id, matching
        # argmax above); a group with zero traffic for the row is no choice
        grp_order = np.argsort(-traffic, axis=0, kind="stable")   # [G, rows]
        ranked_homes = homes[grp_order]
        ranked_traffic = np.take_along_axis(traffic, grp_order, axis=0)
        alt_prefs = np.where(ranked_traffic[1:] > 0,
                             ranked_homes[1:], -1).T               # [rows, G-1]

    shard_of, order = _assign(total, pref, n_shards, rows_per_shard,
                              seed=seed, alt_prefs=alt_prefs,
                              pin_shard=pin_shard)
    # local rows: order of assignment within each shard (hot rows first),
    # derived from the SAME visit order the shards were assigned in
    local = np.empty(rows, dtype=np.int64)
    local[order] = _cumcount(shard_of[order], n_shards)
    dev = (shard_of * rows_per_shard + local).astype(np.int32)
    inv = np.empty(rows, dtype=np.int32)
    inv[dev] = np.arange(rows, dtype=np.int32)
    return PlacementMap(device_row_of_slot=dev, slot_of_device_row=inv,
                        n_shards=int(n_shards),
                        rows_per_shard=int(rows_per_shard))


def solve_placement_incremental(group_traffic: np.ndarray,
                                n_shards: int, rows_per_shard: int, *,
                                pin_shard: np.ndarray,
                                group_ids: Optional[Sequence[int]] = None,
                                seed: int = 0) -> PlacementMap:
    """Bounded-migration re-solve for streaming ingest.

    ``pin_shard[s]`` is the shard slot ``s``'s row held at the LAST solve
    when its demand signature (hottest group + degree) is unchanged since
    then, else ``-1``.  Pinned rows keep their shard (hot-first under the
    capacity bound — ties can spill a cold pinned row, keeping shards
    exactly balanced); only changed/new rows are re-assigned through the
    normal preference passes.  Because an unchanged row's previous shard
    was already the home shard of its hottest group, pinning preserves the
    locality the full solve achieved — ``route_local_fraction`` cannot
    regress beyond the changed set (CI-asserted in the stream smoke).
    """
    return solve_placement(group_traffic, n_shards, rows_per_shard,
                           group_ids=group_ids, seed=seed,
                           pin_shard=np.asarray(pin_shard, dtype=np.int64))


# ---------------------------------------------------------------------------
# serving-side routing table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """Node -> owning cache shard, derived from one live generation.

    This is the placement solver's output re-indexed for a request router:
    ``shard_of_node[v]`` is the shard whose device-table block holds node
    ``v``'s cached row (``-1`` = not cached this generation).  A serving
    fabric sends each request to the worker whose home shard owns the most
    of its ids, so cross-shard gathers become cross-worker hops only on
    misses — the DGL dist-KV "route to the partition owner" shape, with the
    partition book coming from observed traffic instead of a static graph
    cut.
    """
    shard_of_node: np.ndarray   # int16 [num_nodes]; -1 = uncached
    n_shards: int
    version: int                # generation it was derived from

    @property
    def coverage(self) -> float:
        """Fraction of nodes with a known owner shard."""
        n = len(self.shard_of_node)
        return float((self.shard_of_node >= 0).sum()) / n if n else 0.0

    def owners(self, node_ids: np.ndarray) -> np.ndarray:
        """Owning shard per id (-1 where uncached)."""
        return self.shard_of_node[np.asarray(node_ids, dtype=np.int64)]


def routing_table_from_state(state, num_nodes: int) -> RoutingTable:
    """Build the router's view of one (live, un-retired) generation."""
    shard = np.full(int(num_nodes), -1, dtype=np.int16)
    size = len(state.node_ids)
    if size:
        slots = np.arange(size, dtype=np.int32)
        shard[state.node_ids] = state.shard_of(slots).astype(np.int16)
    return RoutingTable(shard_of_node=shard,
                        n_shards=max(int(state.n_shards), 1),
                        version=int(state.version))
