"""Traffic accounting for the multi-tier feature store.

The paper's central systems claim is that a small device-pinned cache removes
most of the host→device feature traffic (Fig. 1: 60–80% of step time is data
copy).  :class:`TrafficMeter` accounts every byte that crosses a tier
boundary so the benchmark harness can reproduce the paper's breakdown
(Fig. 2, Table 4) — now per tier:

* ``device``  — the device-resident cache table (tier 0)
* ``staging`` — the host staging buffer mirroring the device table
* ``host``    — the full host feature array (tier 2, the slow path)

Locality accounting: the meter additionally grows **per-DP-group
request histograms** (``observe_group`` — node-id request counts per group,
the input to ``featurestore.placement.solve_placement``) and counts each
cache hit as *local* or *remote* depending on whether the row's shard is the
requesting group's home shard (``lanes_local`` / ``lanes_remote`` /
``local_hit_fraction``) — the cross-shard lookup traffic the locality-aware
placement minimizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class TierStats:
    """Hit/miss/byte counters for one storage tier."""
    name: str
    hits: int = 0
    misses: int = 0
    bytes_read: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "bytes_read": self.bytes_read,
                "hit_rate": round(self.hit_rate, 4)}


@dataclasses.dataclass
class TrafficMeter:
    """Aggregate host↔device + host-memory traffic counters (bytes / seconds)."""
    bytes_streamed: int = 0        # host -> device feature rows (PCIe analog)
    bytes_sliced: int = 0          # host-memory gather (CPU bandwidth, step 2)
    bytes_cache_fill: int = 0      # cache refresh host-side gather (|C| rows)
    bytes_cache_upload: int = 0    # cache refresh host->device transfer: sum of
                                   # bytes actually landed on each device — a
                                   # shard-aware upload pays table/n_shards per
                                   # device, a replicated one pays the full table
    bytes_adj_upload: int = 0      # per-generation cache-adjacency CSR
                                   # host->device transfer (backend="device"
                                   # sampling) — kept separate from
                                   # bytes_cache_upload so the 1/n sharded-
                                   # upload acceptance ratio stays a pure
                                   # feature-table number
    bytes_delta_upload: int = 0    # streaming-ingest payload absorbed at
                                   # generation merges (edge-op log + new-
                                   # node feature/label rows) — separate
                                   # from bytes_cache_upload/bytes_adj_upload
                                   # for the same reason: the 1/n upload-
                                   # ratio assert must never see ingest bytes
    bytes_rpc_tx: int = 0          # host->host RPC frames shipped (wire
                                   # header + meta + payload) — the fabric's
                                   # cross-host serving transport
    bytes_rpc_rx: int = 0          # host->host RPC frames received
    uploads: int = 0               # device-table uploads (one per generation)
    lanes_local: int = 0           # cache hits served by the requesting
                                   # group's home shard (no cache-axis hop)
    lanes_remote: int = 0          # cache hits resolved on another shard
                                   # (cross-shard traffic the placement
                                   # solver exists to remove)
    bytes_cross_shard: int = 0     # remote-hit rows x row bytes
    t_sample: float = 0.0
    t_slice: float = 0.0
    t_copy: float = 0.0
    t_compute: float = 0.0
    t_refresh: float = 0.0         # background cache-generation build time
    t_prefetch_wait: float = 0.0   # consumer time blocked on the prefetch
                                   # queue (sampler stall)
    steps: int = 0
    tiers: Dict[str, TierStats] = dataclasses.field(default_factory=dict)
    group_hist: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
                                   # DP group -> per-node request counts

    def tier(self, name: str) -> TierStats:
        """Per-tier counters, created on first touch."""
        ts = self.tiers.get(name)
        if ts is None:
            ts = self.tiers[name] = TierStats(name)
        return ts

    @property
    def local_hit_fraction(self) -> float:
        """Fraction of cache hits the requesting group's home shard served."""
        total = self.lanes_local + self.lanes_remote
        return self.lanes_local / total if total else 0.0

    def observe_group(self, group: int, ids: np.ndarray,
                      num_nodes: int) -> None:
        """Accumulate one DP group's requested node ids (hits AND misses —
        the placement solver wants the demand, not the current hit set)."""
        if len(ids) == 0:
            return
        hist = self.group_hist.get(group)
        if hist is None or len(hist) > num_nodes:
            hist = self.group_hist[group] = np.zeros(num_nodes, np.float64)
        elif len(hist) < num_nodes:
            # id space grew (streaming merge): PAD, never reset — the
            # placement solver's demand signal must survive the merge or
            # every generation after an ingest would cold-start contiguous
            grown = np.zeros(num_nodes, np.float64)
            grown[:len(hist)] = hist
            hist = self.group_hist[group] = grown
        np.add.at(hist, np.asarray(ids, dtype=np.int64), 1.0)

    def group_slot_traffic(self, node_ids: np.ndarray,
                           table_rows: int) -> Optional[np.ndarray]:
        """Histograms restricted to one generation's membership, padded to
        the device-table rows — the [n_groups, table_rows] input of
        ``placement.solve_placement`` (None until any traffic is seen).
        Padding slots (``len(node_ids) <= slot < table_rows``) carry zero
        counts, so the solver parks them on whatever capacity is left."""
        if not self.group_hist:
            return None
        groups = sorted(self.group_hist)
        node_ids = np.asarray(node_ids, dtype=np.int64)
        out = np.zeros((len(groups), table_rows), np.float64)
        for gi, g in enumerate(groups):
            hist = self.group_hist[g]
            # ids beyond the histogram are nodes merged in after the last
            # observation — zero demand until traffic touches them
            known = node_ids < len(hist)
            out[gi, :len(node_ids)][known] = hist[node_ids[known]]
        return out

    def group_ids(self) -> list:
        return sorted(self.group_hist)

    def add_batch(self, bytes_streamed: int):
        self.bytes_streamed += bytes_streamed
        self.bytes_sliced += bytes_streamed
        self.steps += 1

    def breakdown(self) -> dict:
        total = self.t_sample + self.t_slice + self.t_copy + self.t_compute
        out = {
            "sample_s": round(self.t_sample, 4),
            "slice_s": round(self.t_slice, 4),
            "copy_s": round(self.t_copy, 4),
            "compute_s": round(self.t_compute, 4),
            "total_s": round(total, 4),
            "refresh_s": round(self.t_refresh, 4),
            "prefetch_wait_s": round(self.t_prefetch_wait, 4),
            "bytes_streamed": self.bytes_streamed,
            "bytes_cache_fill": self.bytes_cache_fill,
            "bytes_cache_upload": self.bytes_cache_upload,
            "bytes_adj_upload": self.bytes_adj_upload,
            "bytes_delta_upload": self.bytes_delta_upload,
            "bytes_rpc_tx": self.bytes_rpc_tx,
            "bytes_rpc_rx": self.bytes_rpc_rx,
            "uploads": self.uploads,
            "steps": self.steps,
            "lanes_local": self.lanes_local,
            "lanes_remote": self.lanes_remote,
            "local_hit_fraction": round(self.local_hit_fraction, 4),
            "bytes_cross_shard": self.bytes_cross_shard,
        }
        if self.tiers:
            out["tiers"] = {k: v.as_dict() for k, v in self.tiers.items()}
        return out
