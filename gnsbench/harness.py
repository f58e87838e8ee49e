"""One run of one cell: set-up, warm-up, the measured window, the trace,
the comparison with the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, a cell or a
per-layer metric sits in files of its own under this directory and is
found by its name:

* ``configs/<config>.json``: the dataset and the model as they are run;
* ``traffic/<traffic>.json``: the training job's parameters (batch,
  fanouts, cache, prefetch depth, warm-up steps);
* ``workloads/<cell>.json``: the cell's configuration, traffic, chips,
  ``why`` and the limits of the numbers its ``correct`` compares;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None`` and
  its ``UNIT``; a reader that finds nothing to read returns None and the
  metric is left out of the line.

The window drives the loop ``GNSEngine.fit`` drives, ``EpochLoader`` →
``Prefetcher`` → ``GNSEngine.run_batch``, with prefetch on.  It starts at
an epoch boundary (the epoch's cache refresh falls inside it) and ends
with the first step that completes after ``seconds``.  The set-up builds
the engine once, drives it through a warm-up epoch cut at the traffic's
``warmup_steps`` (the first of which the reference follows, and every
kernel launches there once), and hands the same engine to the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gnsbench import data as gdata
from gnsbench import flops, reference, trace as gtrace

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


# ---------------------------------------------------------------------------
# the registry: cells, configurations, traffic and metrics by name
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` from its file, with its configuration and traffic
    from theirs."""
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (root / "workloads").glob("*.json"))
        raise SystemExit(f"unknown workload {name!r}; known: {known}")
    wl = _json(path)
    return Cell(name=name, workload=wl,
                config=_json(root / "configs" / f"{wl['config']}.json"),
                traffic=_json(root / "traffic" / f"{wl['traffic']}.json"))


def load_metrics(root: Path = BENCH_DIR) -> dict:
    """Every per-layer metric's reader, by name (the file's stem)."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"gnsbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def engine_config(cell: Cell, seed: int):
    """The port's ``EngineConfig`` for a cell: GNS on the device backend
    with Horvitz-Thompson weights (the path the reference judges), its
    batch, fanouts and cache from the traffic, its model from the
    configuration, ``seed`` for the batch order and the cache draws."""
    from repro_torch.core.sampler import SamplerConfig
    from repro_torch.featurestore import CacheConfig
    from repro_torch.gns.config import EngineConfig, ModelConfig
    from repro_torch.optim.adam import AdamConfig
    t, m = cell.traffic, cell.config["model"]
    if t["kind"] != "train":
        raise ValueError(f"{cell.name}: no reference for {t['kind']!r}")
    if len(t["fanouts"]) != m["num_layers"]:
        raise ValueError(f"{cell.name}: {len(t['fanouts'])} fanouts for "
                         f"{m['num_layers']} layers")
    cache = CacheConfig(fraction=t["cache_fraction"],
                        period=t["refresh_period"],
                        strategy=t["cache_strategy"])
    return EngineConfig(
        sampler="gns",
        sampling=SamplerConfig(fanouts=tuple(t["fanouts"]),
                               batch_size=t["batch_size"], cache=cache,
                               importance_mode="ht", backend="device"),
        cache=cache, model=ModelConfig(hidden_dim=m["hidden_dim"]),
        optim=AdamConfig(lr=m["lr"]), seed=seed, prefetch=True)


def make_weights(cell: Cell, feat_dim: int, seed: int, device) -> list:
    """The initial weights ``w0, b0, w1, b1, ...`` from ``seed``, drawn on
    ``device``: He-scaled normal ``[2 f_in, f_out]`` weights, zero biases."""
    m = cell.config["model"]
    dims = [feat_dim] + [m["hidden_dim"]] * (m["num_layers"] - 1) \
        + [cell.config["data"]["num_classes"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for f_in, f_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((2 * f_in, f_out), generator=gen, device=device)
        out += [w.mul_(math.sqrt(1.0 / f_in)),
                torch.zeros(f_out, device=device)]
    return out


def build_engine(cell: Cell, ds: gdata.Dataset, weights: list, seed: int,
                 device):
    """``GNSEngine`` over the benchmark's dataset, its weights set to
    ``weights``."""
    from repro_torch.gns import GNSEngine
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.datasets import GraphDataset
    gds = GraphDataset(name=cell.workload["config"],
                       graph=CSRGraph(indptr=ds.indptr, indices=ds.indices),
                       features=ds.features, labels=ds.labels,
                       train_idx=ds.train_idx, val_idx=ds.val_idx,
                       test_idx=ds.test_idx, num_classes=ds.num_classes)
    engine = GNSEngine(engine_config(cell, seed), device=device, dataset=gds)
    with torch.no_grad():
        for p, w in zip(_leaves(engine.params), weights):
            p.copy_(w)
    return engine


def _leaves(tree) -> list:
    return [t for layer in tree["layers"] for t in (layer["w"], layer["b"])]


def _snapshot(tree) -> list:
    return [t.detach().to("cpu", copy=True) for t in _leaves(tree)]


def _record(mb) -> dict:
    """The host arrays of one batch that the reference judges."""
    dev = mb.device
    return {"ids": mb.input_node_ids.copy(), "n_in": int(mb.num_input),
            "blocks": [(b.nbr_idx.copy(), b.nbr_w.copy(), b.dst_mask.copy())
                       for b in dev.blocks],
            "fb_rows": dev.input_fb_rows.copy(),
            "fb_w": dev.input_fb_w.copy(),
            "key": [int(x) for x in np.asarray(dev.sample_key).reshape(-1)],
            "labels": dev.labels.copy(), "label_mask": dev.label_mask.copy(),
            "members": mb.cache_gen.state.node_ids.copy(),
            "table_rows": int(mb.cache_gen.state.table_rows),
            "placement": mb.cache_gen.state.placement}


def _until(it, stop: threading.Event):
    """The loader's batches until ``stop`` is set."""
    for mb in it:
        yield mb
        if stop.is_set():
            return


class Feed:
    """One epoch of the loop ``GNSEngine.fit`` drives: the loader's epoch
    through a ``Prefetcher``.  :meth:`next` gives the next batch (None at
    the epoch's end); :meth:`close` stops the producer early, drains the
    queue and joins its thread."""

    def __init__(self, engine, loader, epoch: int, depth: int):
        from repro_torch.core.pipeline import Prefetcher
        self._stop = threading.Event()
        self.prefetcher = Prefetcher(_until(loader.epoch(epoch), self._stop),
                                     depth=depth, meter=engine.meter)
        self._it = iter(self.prefetcher)
        self._done = False

    def next(self):
        mb = None if self._done else next(self._it, None)
        self._done = mb is None
        return mb

    def close(self) -> None:
        self._stop.set()
        while self.next() is not None:   # up to the producer's sentinel
            pass
        self.prefetcher._thread.join()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

K3_STEPS = 3        # window steps whose K3 work a traced run counts

METER_FIELDS = ("t_prefetch_wait", "t_refresh", "t_copy", "bytes_streamed",
                "bytes_cache_upload", "bytes_adj_upload")


def _meter(meter) -> dict:
    out = {f: getattr(meter, f) for f in METER_FIELDS}
    dev = meter.tier("device")
    out["device_hits"], out["device_misses"] = dev.hits, dev.misses
    return out


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: Cell
    window_s: float                  # host clock, first step to last sync
    setup_s: float                   # process start to the first step
    steps: int
    failed: int                      # steps whose loss is not finite
    nodes: int                       # training targets of the window's steps
    meter: dict                      # the engine meter's change over it
    sample_ms: list = dataclasses.field(default_factory=list)
    trace: Optional[gtrace.TraceSummary] = None
    flops: float = 0.0               # model FLOPs of the window's steps
    k3_steps: list = dataclasses.field(default_factory=list)
    k3_bound_ms: Optional[float] = None   # K3's bound a launch


def _steps_flops(cell: Cell, rows: list, feat_dim: int) -> float:
    m = cell.config["model"]
    dims = [feat_dim] + [m["hidden_dim"]] * (m["num_layers"] - 1) \
        + [cell.config["data"]["num_classes"]]
    fan = cell.traffic["fanouts"]
    return float(sum(flops.sage_step_flops(r, fan, dims) for r in rows))


def setup(cell: Cell, seed: int, device,
          ds: Optional[gdata.Dataset] = None, warmup: Optional[int] = None):
    """Dataset, weights, engine and the warm-up epoch.  Returns ``(ds,
    weights, engine, recorded)``: ``recorded`` holds the first
    ``check_steps`` batches, their losses, the AdamW state after the first
    and the weights after the last.  ``ds`` reuses a loaded dataset and
    ``warmup`` overrides the traffic's warm-up steps (the readings)."""
    from repro_torch.core.pipeline import EpochLoader
    t0 = time.perf_counter()
    if ds is None:
        ds = gdata.load_dataset(cell.workload["config"], cell.config["data"],
                                device)
    t1 = time.perf_counter()
    if device.type == "cuda":
        # the peak is the program's: the dataset's draw on the card is not
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    weights = make_weights(cell, ds.features.shape[1], seed, device)
    engine = build_engine(cell, ds, weights, seed, device)
    t2 = time.perf_counter()
    t = cell.traffic
    n_check = t["check_steps"]
    loader = EpochLoader(engine.sampler, ds.train_idx, seed=engine.seed,
                         max_batches=warmup or t["warmup_steps"])
    feed = Feed(engine, loader, 0, t["prefetch_depth"])
    rec = {"steps": [], "losses": []}
    try:
        i = -1
        while (mb := feed.next()) is not None:
            i += 1
            if i < n_check:
                rec["steps"].append(_record(mb))
            loss, _ = engine.run_batch(mb)
            if i < n_check:
                rec["losses"].append(loss)
            if i == 0:
                b1 = engine.cfg.optim.b1
                rec["grad"] = [m / (1.0 - b1)
                               for m in _snapshot(engine.opt_state["m"])]
            if i == n_check - 1:
                rec["params"] = _snapshot(engine.params)
    finally:
        feed.close()
    print(f"set-up: dataset {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, "
          f"warm-up {i + 1} steps {time.perf_counter() - t2:.3f} s",
          file=sys.stderr, flush=True)
    if len(rec["losses"]) < n_check:
        raise RuntimeError(f"warm-up ran {len(rec['losses'])} steps, the "
                           f"check needs {n_check}")
    return ds, weights, engine, rec


def window(engine, cell: Cell, seconds: float, traced: bool,
           prof=None, t_start: float = 0.0) -> Run:
    """The measured window (module docstring)."""
    from repro_torch.core.pipeline import EpochLoader
    from torch.profiler import record_function
    span = record_function if traced else (
        lambda name: contextlib.nullcontext())
    t = cell.traffic
    loader = EpochLoader(engine.sampler, engine.ds.train_idx,
                         seed=engine.seed)
    sample_ms, rows, k3_steps = [], [], []
    if traced:
        inner = engine.sampler.sample

        def sample(targets, rng):
            t0 = time.perf_counter()
            with record_function("gnsbench.sample"):
                mb = inner(targets, rng)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            return mb
        engine.sampler.sample = sample
    before = _meter(engine.meter)
    steps = nodes = failed = 0
    epoch, done = 1, False
    if prof is not None:
        prof.start()
    with span(gtrace.WINDOW_SPAN):
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        deadline = t0 + seconds
        while not done:
            feed = Feed(engine, loader, epoch, t["prefetch_depth"])
            try:
                while True:
                    with span("gnsbench.next_batch"):
                        mb = feed.next()
                    if mb is None:
                        break
                    if traced and len(k3_steps) < K3_STEPS:
                        k3_steps.append(_record(mb))
                    with span("gnsbench.run_batch"):
                        loss, _ = engine.run_batch(mb)
                    steps += 1
                    failed += not math.isfinite(loss)
                    nodes += int(mb.device.label_mask.sum())
                    if traced:
                        rows.append([int(b.dst_mask.sum())
                                     for b in mb.device.blocks])
                    if time.perf_counter() >= deadline:
                        done = True
                        break
            finally:
                feed.close()
            epoch += 1
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    if traced:
        del engine.sampler.sample
    after = _meter(engine.meter)
    run = Run(cell=cell, window_s=t1 - t0, setup_s=setup_s, steps=steps,
              failed=failed, nodes=nodes,
              meter={k: after[k] - before[k] for k in after},
              sample_ms=sample_ms, k3_steps=k3_steps)
    if traced:
        run.flops = _steps_flops(cell, rows, engine.ds.feat_dim)
    return run


def cache_probs(ds: gdata.Dataset, cell: Cell) -> np.ndarray:
    """The reference's §3.2 distribution for the cell's cache policy."""
    policy = reference.resolve_policy(cell.traffic["cache_strategy"],
                                      ds.num_nodes, len(ds.train_idx))
    return reference.cache_probs(ds.indptr, ds.indices, ds.train_idx,
                                 policy)


def _judge(judges: dict, ds: gdata.Dataset, probs: np.ndarray,
           step: dict) -> reference.Judge:
    """The judge of ``step``'s cache generation, made once a generation."""
    key = (step["members"].tobytes(), step["table_rows"])
    if key not in judges:
        judges[key] = reference.Judge(ds.indptr, ds.indices, probs,
                                      step["members"], step["table_rows"])
    return judges[key]


def check(ds: gdata.Dataset, cell: Cell, weights: list, rec: dict,
          device, tf32: bool = False,
          probs: Optional[np.ndarray] = None) -> tuple[dict, dict]:
    """The reference's numbers for the recorded steps: ``bad_samples``
    (lanes, rows and members that break a rule of the sampler),
    ``weight_gap``, ``draw_z`` (the cache draw against its probabilities),
    and the loss, gradient and change gaps.  ``tf32`` computes the
    reference in TF32 and compares it in the program's place (the
    control); ``probs`` reuses the reference's cache distribution.
    Returns the numbers and the detail behind the gaps."""
    t = cell.traffic
    fan = t["fanouts"]
    if probs is None:
        probs = cache_probs(ds, cell)
    steps = rec["steps"]
    bad = 0
    seen = set()
    b = t["batch_size"]
    judges = {}
    layers = []
    for st in steps:
        bad += int(st["placement"] is not None)
        lays = reference.judge_step(_judge(judges, ds, probs, st), st, fan)
        targets = st["ids"][:lays[-1].n]
        if (lays[-1].n != b or (st["label_mask"][:b] != 1).any()
                or (st["label_mask"][b:] != 0).any()
                or (st["labels"][:b] != ds.labels[targets]).any()
                or not np.isin(targets, ds.train_idx).all()
                or seen.intersection(targets.tolist())):
            bad += 1
        seen.update(targets.tolist())
        layers.append(lays)
    bad += sum(j.bad for j in judges.values())   # members and lanes
    ref = reference.follow(steps, layers, ds.features, ds.labels, weights,
                           cell.config["model"]["lr"], device)
    if tf32:
        prog = reference.follow(steps, layers, ds.features, ds.labels,
                                weights, cell.config["model"]["lr"], device,
                                tf32=True)
    else:
        prog = {"losses": rec["losses"], "grad": rec["grad"],
                "params": rec["params"]}
    nums = {"bad_samples": bad,
            "weight_gap": 0.0 if tf32 else max(
                j.weight_gap for j in judges.values()),
            "draw_z": max(j.draw_z for j in judges.values())}
    compared, detail = reference.compare(prog, ref, weights)
    nums.update(compared)
    return nums, detail


def k3_bound_ms(steps: list, ds: gdata.Dataset, cell: Cell,
                probs: np.ndarray) -> Optional[float]:
    """K3's bound a launch: ``flops.sample_work`` and ``bound_ms`` of each
    recorded window step's layer-0 draw, worked out by the reference
    against the step's own cache generation, averaged over the steps."""
    if not steps:
        return None
    k, d = cell.traffic["fanouts"][0], ds.features.shape[1]
    judges, out = {}, []
    for st in steps:
        _, w = _judge(judges, ds, probs, st).layer0(
            st["ids"].astype(np.int64), st["n_in"], st["key"],
            st["fb_rows"], st["fb_w"], k)
        out.append(flops.bound_ms(*flops.sample_work(
            w.bsz, w.k, w.uncached_dst, w.csr_rows, w.nnz,
            w.distinct_rows, w.live_lanes, d))[0])
    return float(np.mean(out))


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             root: Path = BENCH_DIR,
             t_start: Optional[float] = None) -> tuple[dict, list]:
    """One run of cell ``name`` on ``device``.  Returns the result line's
    object and the lines that compare each number with its limit."""
    import gc
    if t_start is None:
        t_start = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = load_cell(name, root)
    readers = load_metrics(root) if traced else {}
    ds, weights, engine, rec = setup(cell, seed, device)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
    run = window(engine, cell, seconds, traced, prof, t_start)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if prof is not None:
        run.trace = gtrace.summarize(prof.profiler.kineto_results.events())
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    del engine, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    probs = cache_probs(ds, cell)
    nums, _ = check(ds, cell, weights, rec, device, probs=probs)
    limits = cell.workload["limits"]
    correct = (set(nums) == set(limits) and run.failed == 0
               and all(math.isfinite(nums[k]) and nums[k] <= limits[k]
                       for k in limits))
    if traced:
        run.k3_bound_ms = k3_bound_ms(run.k3_steps, ds, cell, probs)
        metrics = {}
        for mname, mod in readers.items():
            value = mod.read(run)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {
            "train_nodes_per_s": {"value": run.nodes / run.window_s,
                                  "unit": "nodes/s"},
            "setup_s": {"value": run.setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.steps,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = gtrace.breakdown(run.trace)
    out["compared"] = {k: {"value": nums[k], "limit": limits.get(k)}
                       for k in nums}
    lines = [f"compared {k} {nums[k]!r} limit {limits.get(k)!r}"
             for k in nums]
    return out, lines
