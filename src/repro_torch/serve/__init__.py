"""GNS serving: the persistent request loop off the live cache.

Public surface as in ``repro.serve``: the single-worker
:class:`GNSServer` (``submit()`` / ``infer()`` / ``start()`` / ``stop()``,
or a context manager), :class:`ServeConfig`, :class:`MicroBatcher`,
:class:`ServeMeter` / :class:`BatchRecord`, :class:`ServeResult` /
:class:`ServeFuture` and the control-flow errors :class:`QueueFull` /
:class:`ServerClosed`; and the multi-tenant, multi-worker
:class:`ServeFabric` over one engine (``engine.serve_fabric()``) with its
:class:`FairScheduler` (per-tenant weighted-fair admission), its
:class:`Router` (placement-aware routing) and the failover errors
:class:`WorkerDown` / :class:`WorkerKilled`.  Over
``FabricConfig(transport="tcp")`` the fabric's workers are proxies to
:class:`repro_torch.rpc.WorkerEndpoint` processes.

Quickstart::

    from repro_torch.gns import EngineConfig, GNSEngine

    engine = GNSEngine(EngineConfig.preset("quickstart"))   # on the GPU
    with engine.serve() as server:
        fut = server.submit(node_ids)          # micro-batched + bucketed
        logits = fut.result(timeout=10).logits
    print(server.meter.snapshot())             # p50/p99, hit rate, rejects
"""
from repro_torch.gns.config import FabricConfig, ServeConfig, TenantConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.fabric import (FabricWorker, ServeFabric, WorkerDown,
                                      WorkerKilled)
from repro_torch.serve.metrics import BatchRecord, ServeMeter, TenantStats
from repro_torch.serve.router import RouteDecision, Router
from repro_torch.serve.server import (GNSServer, QueueFull, ServeFuture,
                                      ServeResult, ServerClosed)
from repro_torch.serve.tenancy import FairScheduler, UnknownTenant

__all__ = [
    "GNSServer", "ServeConfig", "MicroBatcher",
    "ServeMeter", "BatchRecord", "TenantStats",
    "ServeResult", "ServeFuture", "QueueFull", "ServerClosed",
    "ServeFabric", "FabricWorker", "FabricConfig", "TenantConfig",
    "FairScheduler", "UnknownTenant",
    "Router", "RouteDecision", "WorkerDown", "WorkerKilled",
]
