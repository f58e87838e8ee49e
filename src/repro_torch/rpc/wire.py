"""Length-prefixed binary wire framing with zero-copy numpy payloads (port
of ``repro.rpc.wire``, byte-compatible with it).

One frame = fixed header + JSON meta + concatenated raw array bytes:

    +--------+------+-------+----------+----------+-------------+
    | magic  | kind | flags | n_arrays | meta_len | payload_len |
    | 4B     | u8   | u8    | u16      | u32      | u64         |
    +--------+------+-------+----------+----------+-------------+
    | meta: UTF-8 JSON (meta_len bytes)                         |
    +-----------------------------------------------------------+
    | payload: array bytes back to back (payload_len bytes)     |
    +-----------------------------------------------------------+

Array layout (dtype string, shape) travels inside the meta JSON under the
reserved ``__arrays__`` key, so the payload itself is raw C-contiguous
bytes — the sender hands ``memoryview``s straight to the socket (no
serialization copy of feature/logit tensors) and the receiver reconstructs
views with ``np.frombuffer``.

Everything here is stdlib + numpy only: the transport must work on a bare
CPU coordinator host with no accelerator runtime.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

MAGIC = b"GNS1"
HEADER = struct.Struct("!4sBBHIQ")          # magic kind flags n_arrays meta payload

# admission bounds: a peer announcing a giant frame is refused BEFORE any
# allocation happens (a garbage length prefix must not OOM the receiver)
MAX_META_BYTES = 1 << 24                    # 16 MiB of JSON is already absurd
MAX_FRAME_BYTES = 1 << 28                   # 256 MiB payload ceiling

# message kinds --------------------------------------------------------------
HELLO = 1          # coordinator -> endpoint: handshake (worker index)
HELLO_ACK = 2      # endpoint -> coordinator: capacity + routing table
REQUEST = 3        # coordinator -> endpoint: one serve request (ids payload)
RESULT = 4         # endpoint -> coordinator: logits / expired / error
HEARTBEAT = 5      # endpoint -> coordinator: liveness + remote beat age
BATCH = 6          # endpoint -> coordinator: one served BatchRecord
REFRESH = 7        # coordinator -> endpoint: kick an async cache refresh
SWAPPED = 8        # endpoint -> coordinator: generation swapped (new table)
STATS_REQ = 9      # coordinator -> endpoint: pull tenant/meter stats
STATS = 10         # endpoint -> coordinator: stats reply
SHUTDOWN = 11      # coordinator -> endpoint: graceful stop
ERROR = 12         # endpoint -> coordinator: fatal endpoint-side failure

KINDS = frozenset({HELLO, HELLO_ACK, REQUEST, RESULT, HEARTBEAT, BATCH,
                   REFRESH, SWAPPED, STATS_REQ, STATS, SHUTDOWN, ERROR})

_ARRAYS_KEY = "__arrays__"


class FrameError(RuntimeError):
    """Malformed frame: bad magic, truncation, oversize, garbage meta."""


class ChannelClosed(ConnectionError):
    """Peer closed the connection at a clean frame boundary."""


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def encode_frame(kind: int,
                 meta: Optional[Mapping] = None,
                 arrays: Optional[Mapping[str, np.ndarray]] = None,
                 ) -> Tuple[list, int]:
    """Build a frame as a list of send buffers (header+meta, then one
    memoryview per array — no payload concatenation copy).

    Returns ``(buffers, total_bytes)``.
    """
    if kind not in KINDS:
        raise FrameError(f"unknown frame kind {kind!r}")
    md = dict(meta or {})
    if _ARRAYS_KEY in md:
        raise FrameError(f"meta key {_ARRAYS_KEY!r} is reserved")
    descs = []
    bufs = []
    payload = 0
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        descs.append([str(name), a.dtype.str, list(a.shape)])
        if a.nbytes:
            bufs.append(memoryview(a).cast("B"))
        payload += a.nbytes
    md[_ARRAYS_KEY] = descs
    mb = json.dumps(md, separators=(",", ":")).encode("utf-8")
    if len(mb) > MAX_META_BYTES:
        raise FrameError(f"meta too large ({len(mb)} bytes)")
    if payload > MAX_FRAME_BYTES:
        raise FrameError(f"payload too large ({payload} bytes)")
    hdr = HEADER.pack(MAGIC, kind, 0, len(descs), len(mb), payload)
    total = HEADER.size + len(mb) + payload
    return [hdr + mb] + bufs, total


def _decode_body(kind: int, n_arrays: int, meta_len: int, payload_len: int,
                 body) -> Tuple[int, dict, Dict[str, np.ndarray]]:
    """Shared tail of frame decoding: ``body`` is meta+payload bytes."""
    if len(body) != meta_len + payload_len:
        raise FrameError("truncated frame body")
    try:
        meta = json.loads(bytes(body[:meta_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"garbage meta JSON: {e}") from None
    if not isinstance(meta, dict):
        raise FrameError("meta is not a JSON object")
    descs = meta.pop(_ARRAYS_KEY, None)
    if not isinstance(descs, list) or len(descs) != n_arrays:
        raise FrameError("array descriptor count mismatch")
    arrays: Dict[str, np.ndarray] = {}
    off = meta_len
    for d in descs:
        try:
            name, dtype_str, shape = d
            dt = np.dtype(dtype_str)
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError) as e:
            raise FrameError(f"garbage array descriptor {d!r}: {e}") from None
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * dt.itemsize
        if off + nbytes > meta_len + payload_len:
            raise FrameError("array descriptors overrun payload")
        arrays[name] = np.frombuffer(body, dtype=dt, count=count,
                                     offset=off).reshape(shape)
        off += nbytes
    if off != meta_len + payload_len:
        raise FrameError("payload bytes left over after array descriptors")
    return kind, meta, arrays


def decode_frame(buf) -> Tuple[int, dict, Dict[str, np.ndarray]]:
    """Decode one complete frame from a bytes-like buffer (strict: the
    buffer must hold exactly one frame)."""
    if len(buf) < HEADER.size:
        raise FrameError("truncated header")
    magic, kind, _flags, n_arrays, meta_len, payload_len = \
        HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if kind not in KINDS:
        raise FrameError(f"unknown frame kind {kind}")
    if meta_len > MAX_META_BYTES or payload_len > MAX_FRAME_BYTES:
        raise FrameError("frame exceeds admission bounds")
    total = HEADER.size + meta_len + payload_len
    if len(buf) < total:
        raise FrameError("truncated frame")
    if len(buf) > total:
        raise FrameError("trailing bytes after frame")
    body = memoryview(buf)[HEADER.size:]
    return _decode_body(kind, n_arrays, meta_len, payload_len, body)


# ---------------------------------------------------------------------------
# socket IO
# ---------------------------------------------------------------------------

def send_frame(sock, kind: int, meta: Optional[Mapping] = None,
               arrays: Optional[Mapping[str, np.ndarray]] = None) -> int:
    """Write one frame; returns bytes sent.  Caller serializes writers."""
    bufs, total = encode_frame(kind, meta, arrays)
    for b in bufs:
        sock.sendall(b)
    return total


def _recv_exact(sock, n: int, *, at_boundary: bool) -> bytearray:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            if got == 0 and at_boundary:
                raise ChannelClosed("peer closed connection")
            raise FrameError("connection closed mid-frame")
        got += k
    return out


def recv_frame(sock) -> Tuple[int, dict, Dict[str, np.ndarray], int]:
    """Read one frame; returns ``(kind, meta, arrays, total_bytes)``.

    Raises :class:`ChannelClosed` on clean EOF between frames,
    :class:`FrameError` on anything malformed.
    """
    hdr = _recv_exact(sock, HEADER.size, at_boundary=True)
    magic, kind, _flags, n_arrays, meta_len, payload_len = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise FrameError(f"bad magic {bytes(magic)!r}")
    if kind not in KINDS:
        raise FrameError(f"unknown frame kind {kind}")
    if meta_len > MAX_META_BYTES or payload_len > MAX_FRAME_BYTES:
        raise FrameError("frame exceeds admission bounds")
    body = _recv_exact(sock, meta_len + payload_len, at_boundary=False)
    k, meta, arrays = _decode_body(kind, n_arrays, meta_len, payload_len, body)
    return k, meta, arrays, HEADER.size + meta_len + payload_len


# ---------------------------------------------------------------------------
# routing-table transport
# ---------------------------------------------------------------------------

def pack_table(table) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Serialize a ``RoutingTable`` (or None) into (meta, arrays)."""
    if table is None:
        return {"has_table": False}, {}
    meta = {"has_table": True, "n_shards": int(table.n_shards),
            "table_version": int(table.version)}
    return meta, {"shard_of_node": np.asarray(table.shard_of_node,
                                              dtype=np.int16)}


def unpack_table(meta: Mapping, arrays: Mapping[str, np.ndarray]):
    """Inverse of :func:`pack_table`; returns a RoutingTable or None."""
    if not meta.get("has_table"):
        return None
    from repro_torch.featurestore.placement import RoutingTable
    return RoutingTable(
        shard_of_node=np.array(arrays["shard_of_node"], dtype=np.int16),
        n_shards=int(meta["n_shards"]),
        version=int(meta["table_version"]))
