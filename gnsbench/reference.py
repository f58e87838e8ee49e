"""The plain reference that decides ``correct`` for a GNS training cell.

Plain NumPy and PyTorch; it imports nothing of the program.  From the
benchmark's own inputs (the graph, the features, the labels, the training
ids, the initial weights) and what the program's timed path produced in
its first steps (each batch's sampled blocks, its layer-0 key and
fallback lanes, the cache generation's members, the losses, the AdamW
state after the first step and the weights after the third), it works
out again:

* the cache distribution of GNS §3.2 (eq. 6 for ``degree``, eqs. 7-9 for
  ``random_walk``), the inclusion rate λ of a draw without replacement
  and each node's hit probability ``p^C = 1 - exp(-λ p)``, and how far
  the generation's members stray from those probabilities (``draw_z``);
* the blocks' weights, eqs. 10-12 in the Horvitz-Thompson form, after
  judging every lane the host sampler drew: a lane must join a node to
  one of its neighbours, without repeats, cached neighbours first and
  uncached ones only as top-up (``bad`` counts every lane or row that
  breaks a rule, ``weight_gap`` is the largest relative gap of the
  program's lane weights from the reference's);
* layer 0's device draw, from the batch's key with murmur3's finalizer
  chained over (key, row, lane), over the generation's CSR of cached
  neighbours, and its aggregate from the host features;
* the GraphSAGE forward, the masked NLL, its gradients and AdamW, in
  float32 with TF32 off (``tf32=True`` turns it on: the control).

The random choices themselves (the cache draw, the host sampler's lanes,
the batch's key) are the program's outputs: they are judged by what they
say (the cache draw by how its members spread over the probabilities),
not drawn again.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MASK32 = np.uint64(0xFFFFFFFF)
GOLDEN = 0x9E3779B9


# ---------------------------------------------------------------------------
# graph helpers
# ---------------------------------------------------------------------------

def ragged(indptr: np.ndarray, indices: np.ndarray, nodes: np.ndarray):
    """Every neighbour of ``nodes`` in one flat array: ``(row, nbr,
    lens)``, ``row[i]`` the position in ``nodes`` of ``nbr[i]``'s node,
    neighbours in CSR order."""
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = indptr[nodes]
    lens = indptr[nodes + 1] - starts
    total = int(lens.sum())
    row = np.repeat(np.arange(len(nodes), dtype=np.int64), lens)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    return row, indices[np.repeat(starts, lens) + off].astype(np.int64), lens


def is_neighbor(indptr: np.ndarray, indices: np.ndarray, v: np.ndarray,
                u: np.ndarray) -> np.ndarray:
    """Whether ``u[i]`` is among ``v[i]``'s neighbours (each row of the
    CSR ascending): a lower bound by bisection on every pair at once."""
    v = np.asarray(v, dtype=np.int64)
    u = np.asarray(u, dtype=np.int64)
    lo, end = indptr[v].copy(), indptr[v + 1]
    hi = end.copy()
    last = max(len(indices) - 1, 0)
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        right = active & (indices[np.minimum(mid, last)] < u)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return (lo < end) & (indices[np.minimum(lo, last)] == u)


# ---------------------------------------------------------------------------
# the cache distribution (GNS §3.2) and its inclusion probabilities
# ---------------------------------------------------------------------------

def resolve_policy(strategy: str, num_nodes: int, num_train: int) -> str:
    """``auto``: the degree distribution (eq. 6) when most nodes train,
    the random walk of eqs. 7-9 when the training set is a small share."""
    if strategy != "auto":
        return strategy
    return "degree" if num_train / num_nodes >= 0.5 else "random_walk"


def cache_probs(indptr: np.ndarray, indices: np.ndarray,
                train_idx: np.ndarray, policy: str,
                walk_fanouts=(15, 10, 5)) -> np.ndarray:
    """The §3.2 distribution over nodes, float64."""
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.float64)
    if policy == "degree":
        return deg / deg.sum()
    if policy != "random_walk":
        raise ValueError(f"no reference for cache policy {policy!r}")
    p = np.zeros(n)
    p[train_idx] = 1.0 / max(len(train_idx), 1)
    scale = np.minimum(np.asarray(walk_fanouts, np.float64)[:, None]
                       / np.maximum(deg, 1.0)[None, :], 1.0)
    src_len = np.diff(indptr)
    for step in range(len(walk_fanouts)):
        # P <- (D A + I) P, D = diag(fanout / deg): each edge v -> u moves
        # p_v * min(fanout / deg_v, 1) onto u
        push = np.repeat(p * scale[step], src_len)
        p = p + np.bincount(indices, weights=push, minlength=n)
        p /= p.sum()
    return p


def inclusion_lambda(probs: np.ndarray, size: int) -> Optional[float]:
    """λ with Σ (1 - exp(-λ p)) = |C| over the positive p (None where the
    cache holds every such node: eq. 11 then)."""
    p = probs[probs > 0]
    if size >= len(p):
        return None
    lo = hi = float(size)
    while -np.expm1(-hi * p).sum() < size:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if -np.expm1(-mid * p).sum() < size:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-13 * lo:
            break
    return 0.5 * (lo + hi)


DRAW_BINS = 16


def draw_z(probs: np.ndarray, pc: np.ndarray, members: np.ndarray,
           bins: int = DRAW_BINS) -> float:
    """How far a cache generation strays from the probabilities it is
    drawn by: the positive-probability nodes in ``bins`` bins of rising
    p^C, each holding an equal share of Σ p^C, and the largest gap between
    a bin's members and its Σ p^C, in standard deviations (the root of
    Σ p^C (1 - p^C), at least 1).  A draw by the §3.2 distribution reads a
    few; one of the most probable nodes, or a uniform one, reads tens."""
    pos = np.nonzero(probs > 0)[0]
    order = pos[np.argsort(pc[pos], kind="stable")]
    w = pc[order]
    before = np.cumsum(w) - w
    b = np.minimum((before * bins / w.sum()).astype(np.int64), bins - 1)
    bin_of = np.full(len(probs), -1, dtype=np.int64)
    bin_of[order] = b
    got = np.bincount(bin_of[members], minlength=bins)[:bins]
    want = np.bincount(b, weights=w, minlength=bins)
    var = np.bincount(b, weights=w * (1.0 - w), minlength=bins)
    return float((np.abs(got - want) / np.sqrt(np.maximum(var, 1.0))).max())


def hit_prob(p: np.ndarray, size: int, lam: Optional[float]) -> np.ndarray:
    """p^C of eq. 11, or 1 - exp(-λ p) with the calibrated λ."""
    if lam is None:
        return -np.expm1(size * np.log1p(-np.minimum(p, 1.0 - 1e-12)))
    return -np.expm1(-lam * p)


def ht_weight(pc: np.ndarray, k: int, n_c: np.ndarray,
              deg: np.ndarray) -> np.ndarray:
    """Eqs. 10-12, Horvitz-Thompson form: 1 / (p^C · min(k, n_c)/n_c ·
    deg), the inclusion clamped at 1e-6."""
    ncv = np.maximum(n_c, 1).astype(np.float64)
    coeff = np.maximum(pc * np.minimum(float(k), ncv) / ncv, 1e-6)
    return 1.0 / (coeff * np.maximum(deg, 1).astype(np.float64))


# ---------------------------------------------------------------------------
# the device draw's hash (murmur3's 32-bit finalizer)
# ---------------------------------------------------------------------------

def _fmix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & MASK32
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & MASK32
    return x ^ (x >> np.uint64(16))


def lane_bits(key_lo: int, key_hi: int, rows: np.ndarray,
              lanes: np.ndarray) -> np.ndarray:
    """fmix32 chained over (golden, key_lo, key_hi, row, lane): the bits
    of each (row, lane) draw, as uint64 values below 2**32."""
    h = np.full(np.broadcast(rows, lanes).shape, GOLDEN, np.uint64)
    for w in (np.uint64(key_lo), np.uint64(key_hi),
              rows.astype(np.uint64), lanes.astype(np.uint64)):
        h = _fmix32(h ^ (w & MASK32))
    return h


# ---------------------------------------------------------------------------
# one step's blocks, worked out and judged
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Layer:
    """One block as the reference computes it: ``n`` destination rows,
    each with lanes into the previous layer's rows (layer 0: into node
    ids) and float32 weights (0 on dead lanes)."""
    n: int
    idx: np.ndarray      # int64 [n, k]; layer 0: node ids, -1 dead
    w: np.ndarray        # float32 [n, k]


@dataclasses.dataclass
class K3Work:
    """What layer 0's draw reads, for kernel K3's bound."""
    bsz: int
    k: int
    uncached_dst: int
    csr_rows: int
    nnz: int
    distinct_rows: int
    live_lanes: int


class Judge:
    """The reference's view of one cache generation: its members, their
    hit probabilities, and the rules a batch drawn against it must keep."""

    def __init__(self, indptr, indices, probs: np.ndarray,
                 members: np.ndarray, table_rows: int):
        self.indptr, self.indices = indptr, indices
        self.deg = np.diff(indptr)
        n = len(indptr) - 1
        self.members = np.asarray(members, dtype=np.int64)
        self.bad = 0
        self.weight_gap = 0.0
        m = self.members
        positive = int((probs > 0).sum())
        # a generation holds min(table rows, positive-probability nodes)
        # distinct nodes of positive probability, ascending
        if (len(m) != min(table_rows, positive) or len(m) == 0
                or (np.diff(m) <= 0).any() or m[0] < 0 or m[-1] >= n
                or (probs[m] <= 0).any()):
            self.bad += 1
            m = np.unique(m[(m >= 0) & (m < n)])
            self.members = m
        self.table_rows = table_rows
        self.in_cache = np.zeros(n, dtype=bool)
        self.in_cache[m] = True
        self.row_of = np.full(n, -1, dtype=np.int64)
        self.row_of[m] = np.arange(len(m))
        lam = inclusion_lambda(probs, len(m))
        self.pc = hit_prob(probs, len(m), lam)
        # a cache that holds every positive-probability node is no draw
        self.draw_z = 0.0 if lam is None else draw_z(probs, self.pc, m)

    def cached_nbrs(self, nodes: np.ndarray):
        """Per node, its number of cached neighbours, and all of them in
        one flat ascending-per-node array with each node's start."""
        row, nbr, _ = ragged(self.indptr, self.indices, nodes)
        inc = self.in_cache[nbr]
        n_c = np.bincount(row[inc], minlength=len(nodes))
        start = np.cumsum(n_c) - n_c
        return n_c, nbr[inc], start

    def _weigh(self, got: np.ndarray, want: np.ndarray,
               live: np.ndarray) -> None:
        """The largest relative gap of a program's lane weight from the
        reference's, over the live lanes."""
        if live.any():
            gap = np.abs(got[live] - want[live]) / np.abs(want[live])
            self.weight_gap = max(self.weight_gap, float(gap.max()))

    def _lanes_ok(self, v, u, live) -> np.ndarray:
        """Per row: every live lane joins the row's node to a neighbour,
        and no neighbour twice."""
        rows, lanes = np.nonzero(live)
        ok = np.ones(live.shape[0], dtype=bool)
        nb = is_neighbor(self.indptr, self.indices, v[rows], u[rows, lanes])
        ok[rows[~nb]] = False
        srt = np.sort(np.where(live, u, -1 - np.arange(live.shape[1])), 1)
        ok &= ~(srt[:, 1:] == srt[:, :-1]).any(axis=1)
        return ok

    def upper(self, ids: np.ndarray, n_src: int, idx: np.ndarray,
              w: np.ndarray, mask: np.ndarray, k: int) -> Layer:
        """A block the host sampler drew (§3.3 with top-up): judged lane by
        lane, weighted again by the reference."""
        n = int(mask.sum())
        if (mask[:n] != 1).any() or (mask[n:] != 0).any() \
                or (w[n:] != 0).any():
            self.bad += 1
        idx = idx[:n].astype(np.int64)
        live = w[:n] != 0
        if (idx[live] >= n_src).any() or (idx[live] < 0).any():
            self.bad += int(((idx >= n_src) | (idx < 0))[live].sum())
            live &= (idx < n_src) & (idx >= 0)
        v = ids[:n]
        u = np.where(live, ids[np.clip(idx, 0, n_src - 1)], -1)
        ok = self._lanes_ok(v, u, live)
        cached = live & self.in_cache[np.maximum(u, 0)]
        n_c, _, _ = self.cached_nbrs(v)
        deg = self.deg[v]
        c, t = cached.sum(1), (live & ~cached).sum(1)
        full = n_c >= k
        ok &= np.where(full, (c == k) & (t == 0),
                       (c == n_c) & (t == np.minimum(k, deg) - n_c))
        self.bad += int((~ok).sum())
        uncond = ht_weight(self.pc[np.maximum(u, 0)], k, n_c[:, None],
                           deg[:, None])
        top = (deg - n_c) / (np.maximum(t, 1) * np.maximum(deg, 1))
        ref_w = np.where(cached, np.where(full[:, None], uncond,
                                          1.0 / np.maximum(deg, 1)[:, None]),
                         top[:, None])
        self._weigh(w[:n], ref_w, live)
        return Layer(n=n, idx=np.where(live, idx, 0),
                     w=np.where(live, ref_w, 0.0).astype(np.float32))

    def layer0(self, ids: np.ndarray, n_in: int, key, fb_rows: np.ndarray,
               fb_w: np.ndarray, k: int) -> tuple[Layer, K3Work]:
        """Layer 0 on the device backend: cached destinations draw from the
        generation's CSR by the batch's key (all their cached neighbours
        when they have at most k, else k draws with replacement); the
        others take the host's fallback lanes, judged like an upper block
        without top-up."""
        v = ids[:n_in].astype(np.int64)
        n_c, cflat, cstart = self.cached_nbrs(v)
        deg = self.deg[v]
        lane = np.arange(k)
        node = np.full((n_in, k), -1, dtype=np.int64)
        drawn = self.in_cache[v]
        r = np.nonzero(drawn)[0]
        if len(r):
            bits = lane_bits(int(key[0]), int(key[1]), r[:, None],
                             lane[None, :])
            ncr = n_c[r][:, None]
            off = np.where(ncr <= k, np.minimum(lane[None, :], ncr - 1),
                           (bits % np.maximum(ncr, 1).astype(np.uint64))
                           .astype(np.int64))
            alive = (ncr > 0) & ((ncr > k) | (lane[None, :] < ncr))
            pick = cflat[np.minimum(cstart[r][:, None] + np.maximum(off, 0),
                                    max(len(cflat) - 1, 0))] \
                if len(cflat) else np.zeros_like(off)
            node[r] = np.where(alive, pick, -1)
        # the fallback lanes of the uncached destinations
        f = np.nonzero(~drawn)[0]
        fb = fb_rows[:n_in].astype(np.int64)
        if (fb_rows[n_in:] >= 0).any() or (fb_w[n_in:] != 0).any():
            self.bad += 1
        frows = fb[f]
        live = frows >= 0
        if (frows[live] >= len(self.members)).any() \
                or (fb_w[:n_in][f][~live] != 0).any():
            self.bad += 1
            live &= frows < len(self.members)
        u = np.where(live, self.members[np.clip(frows, 0,
                                                len(self.members) - 1)], -1)
        ok = self._lanes_ok(v[f], u, live)
        ok &= live.sum(1) == np.minimum(k, n_c[f])
        ok &= (~live | self.in_cache[np.maximum(u, 0)]).all(1)
        self.bad += int((~ok).sum())
        node[f] = u
        alive = node >= 0
        w = np.where(alive, ht_weight(self.pc[np.maximum(node, 0)], k,
                                      n_c[:, None], deg[:, None]), 0.0)
        self._weigh(fb_w[:n_in][f], w[f], live)
        # K3 reads the CSR of every table row and each distinct live row
        nnz = int(self.cached_nbrs(self.members)[0].sum())
        work = K3Work(bsz=len(ids), k=k,
                      uncached_dst=len(ids) - int(drawn.sum()),
                      csr_rows=self.table_rows, nnz=nnz,
                      distinct_rows=len(np.unique(node[alive])),
                      live_lanes=int(alive.sum()))
        return Layer(n=n_in, idx=node, w=w.astype(np.float32)), work


def judge_step(judge: Judge, step: dict, fanouts) -> list:
    """The reference's layers of one recorded step (input-first)."""
    ids = step["ids"].astype(np.int64)
    n_in = int(step["n_in"])
    if len(np.unique(ids[:n_in])) != n_in:
        judge.bad += 1
    l0, _ = judge.layer0(ids, n_in, step["key"], step["fb_rows"],
                         step["fb_w"], fanouts[0])
    layers, n_src = [l0], n_in
    for li in range(1, len(fanouts)):
        idx, w, mask = step["blocks"][li]
        lay = judge.upper(ids, n_src, idx, w, mask, fanouts[li])
        layers.append(lay)
        n_src = lay.n
    return layers


# ---------------------------------------------------------------------------
# GraphSAGE, the masked NLL and AdamW in plain PyTorch
# ---------------------------------------------------------------------------

def sage_loss(params: list, x0: torch.Tensor, a0: torch.Tensor,
              layers: list, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL of GraphSAGE (mean aggregator, concat update, ReLU between
    layers) over the real rows: ``x0`` the input rows' own features,
    ``a0`` their layer-0 aggregate."""
    h = None
    for i, (lay, (w, b)) in enumerate(zip(layers, params)):
        if i == 0:
            z = torch.cat([x0, a0], 1) @ w + b
        else:
            idx = torch.as_tensor(lay.idx, device=h.device)
            lw = torch.as_tensor(lay.w, device=h.device)
            agg = (lw[:, :, None] * h[idx]).sum(1)
            z = torch.cat([h[:lay.n], agg], 1) @ w + b
        h = torch.relu(z) if i < len(layers) - 1 else z
    return -torch.log_softmax(h, 1).gather(1, labels[:, None]).mean()


def adamw(params: list, grads: list, state: dict, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW step in place (no weight decay)."""
    state["t"] += 1
    t = state["t"]
    for i, (p, g) in enumerate(zip(params, grads)):
        m = state["m"][i].mul_(b1).add_(g, alpha=1 - b1)
        v = state["v"][i].mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps))


def follow(steps: list, layers: list, features: np.ndarray,
           labels: np.ndarray, params0: list, lr: float, device,
           tf32: bool = False) -> dict:
    """The reference's run of the recorded steps from ``params0`` (``w0,
    b0, w1, b1, ...``): each step's loss, the first step's gradients and
    the weights after the last."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = [t.detach().to(device, torch.float32).clone()
                  for t in params0]
        state = {"t": 0, "m": [torch.zeros_like(p) for p in params],
                 "v": [torch.zeros_like(p) for p in params]}
        losses, grad1 = [], None
        for step, lays in zip(steps, layers):
            l0 = lays[0]
            x_in = torch.from_numpy(
                features[step["ids"][:l0.n].astype(np.int64)]).to(device)
            alive = l0.idx >= 0
            rows = torch.from_numpy(
                features[np.where(alive, l0.idx, 0).reshape(-1)]).to(device)
            a0 = (torch.from_numpy(l0.w).to(device)[:, :, None]
                  * rows.view(l0.n, l0.idx.shape[1], -1)).sum(1)
            del rows
            lab = torch.from_numpy(labels[step["ids"][:lays[-1].n]]
                                   .astype(np.int64)).to(device)
            leaves = [p.clone().requires_grad_(True) for p in params]
            pairs = list(zip(leaves[0::2], leaves[1::2]))
            loss = sage_loss(pairs, x_in, a0, lays, lab)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.item())
            if grad1 is None:
                grad1 = [g.detach().clone() for g in grads]
            with torch.no_grad():
                adamw(params, grads, state, lr)
        return {"losses": losses, "grad": grad1, "params": params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------

def _norms(leaves) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double()))
                     for t in leaves])


def leaf_gaps(got: list, want: list) -> np.ndarray:
    """Each leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    g, w = _norms(got), _norms(want)
    return np.abs(g - w) / np.maximum(w, np.median(w))


def compare(prog: dict, ref: dict, params0: list) -> tuple[dict, dict]:
    """The numbers compared, and the detail behind them.

    ``first_loss_gap``: the relative gap of the first step's loss (the
    later steps' losses swing from seed to seed: see ``PERF.md``);
    ``out_grad_gap``: the first step's gradients of the output layer (the
    last two leaves) by the worse leaf.  Below it a pre-activation within
    rounding of 0 takes the other side of the ReLU now and then, and moves
    a lower leaf's gradient by up to 1e-5 of its norm on a sound seed
    (``PERF.md``); the output layer's gradient has no ReLU mask in it.
    ``change_gap``: the weights' change over the steps by the worst leaf,
    leaving out leaves whose reference gradient is under a thousandth of
    the median leaf's (round-off alone would move them).  The detail:
    every step's loss gap and every leaf's gaps."""
    lp, lr = np.array(prog["losses"]), np.array(ref["losses"])
    steps = np.abs(lp - lr) / np.abs(lr)
    steps = np.where(np.isfinite(steps), steps, np.inf)
    gnorm = _norms(ref["grad"])
    keep = gnorm >= 1e-3 * np.median(gnorm)
    dev = ref["params"][0].device
    p0 = [t.to(dev) for t in params0]
    d_prog = [a.to(dev) - b for a, b in zip(prog["params"], p0)]
    d_ref = [a - b for a, b in zip(ref["params"], p0)]
    grad = leaf_gaps([g.to(dev) for g in prog["grad"]], ref["grad"])
    kept = [i for i in range(len(keep)) if keep[i]]
    change = leaf_gaps([d_prog[i] for i in kept], [d_ref[i] for i in kept])
    nums = {"first_loss_gap": float(steps[0]),
            "out_grad_gap": float(grad[-2:].max()),
            "change_gap": float(change.max())}
    detail = {"loss_gaps": steps.tolist(), "grad_leaf_gaps": grad.tolist(),
              "change_leaf_gaps": change.tolist(),
              "kept_leaves": kept}
    return nums, detail
