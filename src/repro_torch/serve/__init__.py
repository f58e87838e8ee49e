"""GNS serving: the persistent request loop off the live cache.

Public surface as in ``repro.serve`` for the single-worker server:
:class:`GNSServer` (``submit()`` / ``infer()`` / ``start()`` / ``stop()``,
or a context manager), :class:`ServeConfig`, :class:`MicroBatcher`,
:class:`ServeMeter` / :class:`BatchRecord`, :class:`ServeResult` /
:class:`ServeFuture` and the control-flow errors :class:`QueueFull` /
:class:`ServerClosed`.  The multi-tenant fabric, router and RPC transport
are not ported yet.

Quickstart::

    from repro_torch.gns import EngineConfig, GNSEngine

    engine = GNSEngine(EngineConfig.preset("quickstart"))   # on the GPU
    with engine.serve() as server:
        fut = server.submit(node_ids)          # micro-batched + bucketed
        logits = fut.result(timeout=10).logits
    print(server.meter.snapshot())             # p50/p99, hit rate, rejects
"""
from repro_torch.gns.config import ServeConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord, ServeMeter, TenantStats
from repro_torch.serve.server import (GNSServer, QueueFull, ServeFuture,
                                      ServeResult, ServerClosed)

__all__ = [
    "GNSServer", "ServeConfig", "MicroBatcher",
    "ServeMeter", "BatchRecord", "TenantStats",
    "ServeResult", "ServeFuture", "QueueFull", "ServerClosed",
]
