"""Cross-host serving quickstart on the PyTorch port: endpoint replicas over
localhost TCP.

Twin of ``examples/serve_rpc.py`` on ``repro_torch``.  The deployment shape
(one process per box in production; here everything runs on localhost so
the example is self-contained):

* N ``WorkerEndpoint`` processes, each hosting a full engine replica — its
  own feature-store cache and micro-batcher, and on a CUDA card its own
  copy of the kernel extension: every batch's layer 0 runs the fused
  cache-lookup kernel (K1) and its upper layers the gather-aggregate kernel
  (K2) — started with::

      python -m repro_torch.rpc.endpoint --config engine.json --index 0 \\
          --port 7001

* ONE coordinator that connects a :class:`~repro_torch.serve.ServeFabric`
  with ``transport="tcp"`` to those endpoints.  It computes nothing:
  routing, tenancy, heartbeat liveness and failover ride the in-process
  fabric's code path, with :class:`~repro_torch.rpc.RemoteWorkerProxy` in
  place of a worker thread.

By default the endpoints are REAL subprocesses (separate interpreters,
separate caches, bytes on a socket); ``--in-thread`` serves them on threads
instead.  ``--kill-endpoint`` SIGKILLs endpoint 0 mid-stream to show
lossless failover onto the survivor.  Everything runs on the GPU unless
``--device cpu`` is given (the endpoints get the same flag).

Run:  PYTHONPATH=src python examples/serve_rpc_torch.py [--requests 100] \\
          [--kill-endpoint] [--in-thread] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core.sampler import SamplerConfig
from repro_torch.featurestore import CacheConfig
from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,
                             ModelConfig, ServeConfig, TenantConfig)
from repro_torch.gns.config import DataConfig

SRC = Path(__file__).resolve().parents[1] / "src"


def _engine_config(dataset: str, scale: float) -> EngineConfig:
    return EngineConfig(
        sampler="gns",
        data=DataConfig(name=dataset, scale=scale),
        sampling=SamplerConfig(batch_size=128, fanouts=(5, 10)),
        cache=CacheConfig(fraction=0.05, strategy="adaptive"),
        model=ModelConfig(input_impl="fused"),
        serve=ServeConfig(buckets=(16, 64), max_wait_ms=2.0))


def _spawn_subprocess_endpoints(cfg_path: str, n: int, device):
    """One ``python -m repro_torch.rpc.endpoint`` process per replica."""
    procs, ports = [], []
    for i in range(n):
        cmd = [sys.executable, "-m", "repro_torch.rpc.endpoint",
               "--config", cfg_path, "--index", str(i), "--port", "0"]
        if device is not None:
            cmd += ["--device", device]
        procs.append(subprocess.Popen(
            cmd, env=dict(os.environ, PYTHONPATH=str(SRC)),
            stdout=subprocess.PIPE, text=True))
    for p in procs:
        line = p.stdout.readline()   # the READY line, or EOF if it died
        assert "GNS_ENDPOINT_READY" in line, line
        ports.append(int(dict(kv.split("=")
                              for kv in line.split()[1:])["port"]))
        print(f"  endpoint up: pid={p.pid} port={ports[-1]}")
    return procs, ports


def _spawn_thread_endpoints(cfg: EngineConfig, n: int, device):
    from repro_torch.rpc import WorkerEndpoint
    eps = []
    for i in range(n):
        ep = WorkerEndpoint(GNSEngine(cfg, device=device), index=i)
        ep.serve_in_thread()
        eps.append(ep)
        print(f"  endpoint up (thread): port={ep.port}")
    return eps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--endpoints", type=int, default=2)
    ap.add_argument("--in-thread", action="store_true",
                    help="serve endpoints on threads instead of subprocesses")
    ap.add_argument("--kill-endpoint", action="store_true",
                    help="SIGKILL endpoint 0 mid-stream (subprocess mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = _engine_config(args.dataset, args.scale)
    print(f"starting {args.endpoints} endpoint replicas ...")
    procs, eps = [], []
    with tempfile.TemporaryDirectory() as d:
        cfg_path = os.path.join(d, "engine.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg.to_dict(), f)
        try:
            if args.in_thread:
                eps = _spawn_thread_endpoints(cfg, args.endpoints,
                                              args.device)
                ports = [ep.port for ep in eps]
            else:
                procs, ports = _spawn_subprocess_endpoints(
                    cfg_path, args.endpoints, args.device)
            _serve(args, cfg, procs, ports)
        finally:
            for ep in eps:
                ep.stop()
            for ep in eps:          # no endpoint thread outlives main()
                ep.join()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)


def _serve(args, cfg, procs, ports) -> None:
    coordinator = GNSEngine.coordinator(cfg, device=args.device)
    fab = coordinator.serve_fabric(FabricConfig(
        workers=args.endpoints, transport="tcp",
        endpoints=tuple(f"127.0.0.1:{p}" for p in ports),
        tenants=(TenantConfig("mobile", weight=2.0,
                              max_queue=args.requests + 8),
                 TenantConfig("batch", weight=1.0,
                              max_queue=args.requests + 8))))

    rng = np.random.default_rng(0)
    pool = coordinator.ds.val_idx
    print(f"serving {args.requests} requests over TCP ...")
    with fab:
        futs = []
        for i in range(args.requests):
            ids = rng.choice(pool, size=int(rng.integers(2, 10)),
                             replace=False)
            futs.append(fab.submit(
                ids, tenant="mobile" if i % 2 == 0 else "batch"))
            if args.kill_endpoint and procs and i == args.requests // 2:
                os.kill(procs[0].pid, signal.SIGKILL)
                print("SIGKILLed endpoint 0 — the watchdog reclaims its "
                      "in-flight requests, and the survivor re-serves "
                      "them ...")
        for f in futs:
            r = f.result(timeout=600)
            assert r.status == "ok" and np.isfinite(r.logits).all()
        remote = fab.pull_remote_stats(timeout=30.0)
        snap = fab.snapshot()

    print(f"served {args.requests}/{args.requests}; wire bytes "
          f"tx={snap['rpc']['bytes_rpc_tx']:,} "
          f"rx={snap['rpc']['bytes_rpc_rx']:,}; errors {snap['errors']}")
    for idx, stats in sorted(remote.items()):
        c = stats["counters"]
        print(f"  endpoint {idx}: served {c['served']:>4}  "
              f"rx {c['bytes_rpc_rx']:>9,}B  tx {c['bytes_rpc_tx']:>9,}B")
    if args.kill_endpoint:
        rt = snap["routing"]
        print(f"failovers {rt['failovers']}, retries {rt['retries']}, "
              f"healthy at exit: {fab.healthy()}")


if __name__ == "__main__":
    main()
