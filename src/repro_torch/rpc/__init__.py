"""Cross-host serving transport (port of ``repro.rpc``, byte-compatible
with it on the wire).

The fabric's cross-HOST leg: length-prefixed binary framing with zero-copy
numpy payloads (:mod:`repro_torch.rpc.wire`), a retrying heartbeat-carrying
client :class:`~repro_torch.rpc.channel.Channel`, a per-host worker process
(:class:`~repro_torch.rpc.endpoint.WorkerEndpoint`, ``python -m
repro_torch.rpc.endpoint``, on the GPU unless ``--device cpu``), and the
:class:`~repro_torch.rpc.proxy.RemoteWorkerProxy` that slots into
:class:`~repro_torch.serve.fabric.ServeFabric` unchanged
(``FabricConfig(transport="tcp", endpoints=("host:port", ...))``).

The coordinator half (wire, channel, proxy) computes nothing and builds no
kernel; only the endpoint pulls in the engine.
"""
from .channel import Channel, RpcError
from .proxy import RemoteWorkerProxy, parse_endpoint
from .wire import (ChannelClosed, FrameError, MAX_FRAME_BYTES, decode_frame,
                   encode_frame, pack_table, recv_frame, send_frame,
                   unpack_table)

__all__ = [
    "Channel", "ChannelClosed", "FrameError", "MAX_FRAME_BYTES",
    "RemoteWorkerProxy", "RpcError", "WorkerEndpoint", "decode_frame",
    "encode_frame", "pack_table", "parse_endpoint", "recv_frame",
    "send_frame", "unpack_table",
]


def __getattr__(name):
    # WorkerEndpoint pulls in the engine on use — resolve it lazily so
    # `import repro_torch.rpc` stays cheap on coordinator-only hosts
    if name == "WorkerEndpoint":
        from .endpoint import WorkerEndpoint
        return WorkerEndpoint
    raise AttributeError(name)
