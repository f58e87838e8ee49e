"""Static-shape padded minibatch blocks (port of ``repro.core.minibatch``).

Every GNN layer ℓ is a :class:`LayerBlock` mapping a padded source-node array
(representations at layer ℓ-1) to a padded destination-node array (layer ℓ):

* ``nbr_idx[d, k]`` — index into this block's **source axis** of the k-th
  sampled neighbor of destination d.  Pure gather; no scatter needed.
* ``nbr_w[d, k]``  — aggregation weight.  Carries BOTH the importance-sampling
  correction of eq. (10)–(12) AND the mean normalization; padded lanes are 0,
  so masked lanes drop out of the weighted sum for free.
* destinations are the **first** ``num_dst`` entries of the source array, so
  the self-representation needed by GraphSAGE's concat is ``h_src[:num_dst]``.

The padded layout turns sparse neighbor aggregation into a dense
``gather + weighted sum over k`` — the shape the CUDA ``gather_agg`` and
``cache_lookup_agg`` kernels consume (``repro_torch.kernels``).

The samplers build every array in numpy on the host.  :meth:`DeviceBatch.to`
ships the device part to a torch device: for a CUDA target each array is
copied into pinned host memory and from there with ``non_blocking=True``,
so the copies queue on the current stream behind no host synchronisation.
Shapes depend only on (batch, fanouts), never on the sampled graph;
``num_src`` / ``num_dst`` are plain ints.  Host-only metadata (actual node
counts, bytes streamed) lives on :class:`MiniBatch`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on ``device``.

    A CUDA copy goes through pinned memory with ``non_blocking=True``; the
    caching host allocator keeps the pinned buffer alive until the copy has
    run.  A CPU target gets a tensor over its own copy of the array.
    """
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


@dataclasses.dataclass
class LayerBlock:
    nbr_idx: np.ndarray   # int32 [D, K] gather indices into src axis
    nbr_w: np.ndarray     # f32   [D, K] aggregation weights (0 = masked lane)
    dst_mask: np.ndarray  # f32   [D]    1 for real dst rows
    num_src: int = 0
    num_dst: int = 0

    def to(self, device) -> "LayerBlock":
        device = torch.device(device)
        return LayerBlock(nbr_idx=_to_device(self.nbr_idx, device),
                          nbr_w=_to_device(self.nbr_w, device),
                          dst_mask=_to_device(self.dst_mask, device),
                          num_src=self.num_src, num_dst=self.num_dst)


@dataclasses.dataclass
class DeviceBatch:
    """The arrays one forward consumes (numpy on the host, tensors after
    :meth:`to`).  The host GNS sampler leaves the three device-backend
    fields of ``repro.core.minibatch.DeviceBatch`` out: that backend is not
    ported yet."""
    blocks: tuple                  # tuple[LayerBlock], input -> output order
    input_cache_slots: np.ndarray  # int32 [S0]  slot in device cache or -1
    input_streamed: np.ndarray     # f32 [S0, F] host-gathered rows (0 for hits)
    input_mask: np.ndarray         # f32 [S0]
    labels: np.ndarray             # int32 [B]
    label_mask: np.ndarray         # f32 [B]

    def to(self, device) -> "DeviceBatch":
        device = torch.device(device)
        return DeviceBatch(
            blocks=tuple(b.to(device) for b in self.blocks),
            input_cache_slots=_to_device(self.input_cache_slots, device),
            input_streamed=_to_device(self.input_streamed, device),
            input_mask=_to_device(self.input_mask, device),
            labels=_to_device(self.labels, device),
            label_mask=_to_device(self.label_mask, device))


@dataclasses.dataclass
class MiniBatch:
    """Host-side minibatch: device part + bookkeeping that never ships."""
    device: DeviceBatch
    input_node_ids: np.ndarray     # int64 [S0] global ids (pad = 0)
    num_input: int = 0             # distinct input nodes (paper Table 4)
    num_cached: int = 0            # of which served by the device cache
    bytes_streamed: int = 0        # host->device feature bytes this batch
    num_isolated: int = 0          # input-layer dst rows with no valid lane (Table 5)
    cache_gen: object = None       # featurestore.Generation the slots index
                                   # into (pairs slots with THEIR device table,
                                   # so an async cache swap can never tear a
                                   # batch)
    local_shard: object = None     # home shard when every hit is local to
                                   # it (None unless the table has shards)

    @property
    def cache_version(self) -> int:
        """Version of the generation the slots resolve against (-1 = none)."""
        return self.cache_gen.version if self.cache_gen is not None else -1


def block_pad_sizes(batch_size: int, fanouts: Sequence[int]) -> list[tuple[int, int]]:
    """Static (num_dst, num_src) per block, input-layer first.

    Worst case without dedup: S_ℓ = D_ℓ·(1+k_ℓ), chained from the output layer
    (D_L = batch) down to the input layer.  Dedup only shrinks the *real*
    counts; padding uses the bound so shapes are run-constant.
    """
    sizes = []
    d = batch_size
    for k in reversed(list(fanouts)):      # output layer first
        s = d * (1 + k)
        sizes.append((d, s))
        d = s
    return list(reversed(sizes))           # back to input-first


def pad_to(arr: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    pad = n - arr.shape[axis]
    assert pad >= 0, f"padded size {n} < actual {arr.shape[axis]}"
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def make_block(nbr_idx: np.ndarray, nbr_w: np.ndarray,
               pad_dst: int, pad_src: int) -> LayerBlock:
    """Pad a ragged (D, K) block to the static (pad_dst, K) shape."""
    d, _ = nbr_idx.shape
    dst_mask = np.zeros(pad_dst, dtype=np.float32)
    dst_mask[:d] = 1.0
    return LayerBlock(
        nbr_idx=pad_to(nbr_idx.astype(np.int32), pad_dst, axis=0),
        nbr_w=pad_to(nbr_w.astype(np.float32), pad_dst, axis=0),
        dst_mask=dst_mask,
        num_src=pad_src,
        num_dst=pad_dst,
    )
