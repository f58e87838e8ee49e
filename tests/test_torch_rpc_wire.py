"""The port's RPC wire framing (``repro_torch.rpc.wire``): the reference's
property battery (``tests/test_rpc_wire.py``) run on the port, and the
frames held byte for byte against the reference's.

* Every kind round-trips bitwise (dtype, shape and bytes through the
  zero-copy path); every class of malformed input (truncation, bad magic,
  oversize announcements, lying descriptors, EOF mid-frame) is rejected
  with ``FrameError`` before any payload-sized allocation.
* Across packages: for every kind, with arrays of several dtypes and
  shapes, the port's ``encode_frame`` buffers equal the reference's, and a
  frame or a routing table from either package decodes in the other.
* The garbage-prefix limit, shared with the reference: the kind byte of a
  frame changed to another valid kind, or its reserved flags byte changed,
  leaves a valid frame (the header carries no checksum), so the twin of
  ``test_garbage_prefix_rejected`` leaves out those mutations, and one test
  holds that both packages decode such frames the same way.

Runs property-style under hypothesis when installed, via the seeded
fallback shim otherwise.  The socket tests wait on frames, never on a
sleep.
"""
from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                          # pragma: no cover
    from _hypothesis_fallback import given, settings, st

pytest.importorskip("torch")

from repro.featurestore.placement import RoutingTable as RoutingTableRef  # noqa: E402
from repro.rpc import wire as wire_ref  # noqa: E402
from repro_torch.featurestore.placement import RoutingTable  # noqa: E402
from repro_torch.rpc import wire  # noqa: E402
from repro_torch.rpc.wire import (ChannelClosed, FrameError,  # noqa: E402
                                  decode_frame, encode_frame, pack_table,
                                  recv_frame, send_frame, unpack_table)

ALL_KINDS = sorted(wire.KINDS)
DTYPES = [np.int64, np.int32, np.int16, np.int8, np.float32, np.float64,
          np.uint8, np.bool_]
SOCK_TIMEOUT_S = 30.0


def _bytes_of(frame_bufs) -> bytes:
    return b"".join(bytes(b) for b in frame_bufs)


def _roundtrip(kind, meta, arrays):
    bufs, total = encode_frame(kind, meta, arrays)
    raw = _bytes_of(bufs)
    assert len(raw) == total
    k, m, a = decode_frame(raw)
    assert k == kind
    assert m == dict(meta or {})
    assert set(a) == set(arrays or {})
    for name, arr in (arrays or {}).items():
        got = a[name]
        assert got.dtype == np.asarray(arr).dtype, name
        assert got.shape == np.ascontiguousarray(arr).shape, name
        np.testing.assert_array_equal(got, np.asarray(arr))
    return raw


def _arrays(rng, di, ndim, dim, n_arrays):
    arrays = {}
    for j in range(n_arrays):
        dt = DTYPES[(di + j) % len(DTYPES)]
        shape = tuple(int(rng.integers(0, dim + 1)) for _ in range(ndim))
        arrays[f"a{j}"] = (rng.integers(0, 2, size=shape).astype(dt)
                           if dt is np.bool_ else
                           (rng.random(size=shape) * 100).astype(dt))
    return arrays


def _socketpair():
    a, b = socket.socketpair()
    a.settimeout(SOCK_TIMEOUT_S)
    b.settimeout(SOCK_TIMEOUT_S)
    return a, b


# ---------------------------------------------------------------------------
# the format itself is the reference's
# ---------------------------------------------------------------------------

def test_format_constants_match_reference():
    assert wire.MAGIC == wire_ref.MAGIC == b"GNS1"
    assert wire.HEADER.format == wire_ref.HEADER.format == "!4sBBHIQ"
    assert wire.KINDS == wire_ref.KINDS == frozenset(range(1, 13))
    for name in ("HELLO", "HELLO_ACK", "REQUEST", "RESULT", "HEARTBEAT",
                 "BATCH", "REFRESH", "SWAPPED", "STATS_REQ", "STATS",
                 "SHUTDOWN", "ERROR", "MAX_META_BYTES", "MAX_FRAME_BYTES",
                 "_ARRAYS_KEY"):
        assert getattr(wire, name) == getattr(wire_ref, name), name


# ---------------------------------------------------------------------------
# round-trip properties
# ---------------------------------------------------------------------------

def test_all_kinds_roundtrip_empty():
    for kind in ALL_KINDS:
        _roundtrip(kind, {}, {})
        _roundtrip(kind, {"x": 1, "s": "τ", "none": None, "f": 0.5,
                          "nested": {"a": [1, 2]}}, {})


@settings(max_examples=25)
@given(st.integers(0, len(ALL_KINDS) - 1),
       st.integers(0, len(DTYPES) - 1),
       st.integers(0, 3),                    # ndim
       st.integers(0, 9),                    # dim size
       st.integers(1, 4))                    # number of arrays
def test_roundtrip_dtype_shape_preserved(ki, di, ndim, dim, n_arrays):
    rng = np.random.default_rng(ki * 1000 + di * 100 + ndim * 10 + dim)
    _roundtrip(ALL_KINDS[ki], {"req": ki},
               _arrays(rng, di, ndim, dim, n_arrays))


def test_roundtrip_empty_and_scalar_shapes():
    _roundtrip(wire.RESULT, {}, {"s": np.float32(3.5) * np.ones(())})
    _roundtrip(wire.RESULT, {}, {"e": np.zeros((0, 4), np.int64)})
    f_ordered = np.asfortranarray(np.arange(12, np.float32(12) + 12)
                                  .reshape(3, 4))
    bufs, _ = encode_frame(wire.RESULT, {}, {"f": f_ordered})
    _, _, a = decode_frame(_bytes_of(bufs))
    np.testing.assert_array_equal(a["f"], f_ordered)


def test_zero_copy_views_on_receive():
    arr = np.arange(64, dtype=np.int64)
    raw = _bytes_of(encode_frame(wire.REQUEST, {"req": 1}, {"ids": arr})[0])
    _, _, a = decode_frame(raw)
    assert a["ids"].base is not None         # a view over the frame buffer


# ---------------------------------------------------------------------------
# rejection properties
# ---------------------------------------------------------------------------

def test_unknown_kind_and_reserved_key_rejected_on_encode():
    with pytest.raises(FrameError):
        encode_frame(200, {}, {})
    with pytest.raises(FrameError):
        encode_frame(wire.HELLO, {wire._ARRAYS_KEY: []}, {})


def test_oversize_payload_rejected_on_encode(monkeypatch):
    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 1 << 10)
    with pytest.raises(FrameError):
        encode_frame(wire.REQUEST, {}, {"x": np.zeros(1 << 12, np.int8)})


@settings(max_examples=25)
@given(st.integers(0, 200))
def test_truncated_frame_rejected(cut):
    raw = _roundtrip(wire.REQUEST, {"req": 7},
                     {"ids": np.arange(17, dtype=np.int64)})
    cut = min(cut, len(raw) - 1)
    with pytest.raises(FrameError):
        decode_frame(raw[:cut])


def _mutate(raw: bytes, pos: int, val: int) -> bytes:
    """The reference test's mutation: byte ``pos`` changed by 1 + val."""
    out = bytearray(raw)
    orig = out[pos]
    out[pos] = (orig + 1 + val) % 256
    if out[pos] == orig:
        out[pos] = (orig + 1) % 256
    return bytes(out)


_KIND_POS = 4                      # offset of the kind byte in the header
_FLAGS_POS = 5                     # offset of the flags byte (reserved)


@settings(max_examples=25)
@given(st.integers(0, 19), st.integers(0, 255))
def test_garbage_prefix_rejected(pos, val):
    raw = _roundtrip(wire.HEARTBEAT, {"beat_age_s": 0.0}, {})
    bad = _mutate(raw, pos, val)
    if pos == _FLAGS_POS or (pos == _KIND_POS and bad[pos] in wire.KINDS):
        return      # still a valid frame (the test below)
    with pytest.raises(FrameError):
        decode_frame(bad)


@pytest.mark.parametrize("pos,value", (
    [(_KIND_POS, k) for k in sorted(wire.KINDS - {wire.HEARTBEAT})]
    + [(_FLAGS_POS, f) for f in (1, 0x80, 0xFF)]))
def test_valid_header_mutations_decode_alike(pos, value):
    """The limit both packages share: no checksum guards the header, and
    decoding ignores the reserved flags byte.  A HEARTBEAT whose kind byte
    reads another valid kind decodes as that kind, and one with other flags
    decodes unchanged, with the same meta, in the port and in the
    reference."""
    raw = bytearray(_roundtrip(wire.HEARTBEAT, {"beat_age_s": 0.0}, {}))
    raw[pos] = value
    got = decode_frame(bytes(raw))
    want = wire_ref.decode_frame(bytes(raw))
    kind = value if pos == _KIND_POS else wire.HEARTBEAT
    assert got[0] == want[0] == kind
    assert got[1] == want[1] == {"beat_age_s": 0.0}
    assert got[2] == want[2] == {}


def test_admission_bounds_checked_before_allocation():
    hdr = wire.HEADER.pack(wire.MAGIC, wire.REQUEST, 0, 0, 0, 1 << 60)
    with pytest.raises(FrameError, match="admission"):
        decode_frame(hdr)
    hdr = wire.HEADER.pack(wire.MAGIC, wire.REQUEST, 0, 0,
                           wire.MAX_META_BYTES + 1, 0)
    with pytest.raises(FrameError, match="admission"):
        decode_frame(hdr)
    # the socket path refuses from the 20-byte header alone, too
    a, b = _socketpair()
    try:
        a.sendall(wire.HEADER.pack(wire.MAGIC, wire.RESULT, 0, 0, 0,
                                   wire.MAX_FRAME_BYTES + 1))
        with pytest.raises(FrameError, match="admission"):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_descriptor_lies_rejected():
    bufs, _ = encode_frame(wire.RESULT, {}, {"x": np.zeros(4, np.int64)})
    raw = bytearray(_bytes_of(bufs))
    raw2 = raw.replace(b'"<i8",[4]', b'"<i8",[9]')
    assert raw2 != raw
    with pytest.raises(FrameError):
        decode_frame(bytes(raw2))
    with pytest.raises(FrameError, match="trailing"):
        decode_frame(bytes(raw) + b"\x00")
    mb = b"[1,2]"
    hdr = wire.HEADER.pack(wire.MAGIC, wire.HELLO, 0, 0, len(mb), 0)
    with pytest.raises(FrameError, match="not a JSON object"):
        decode_frame(hdr + mb)
    # a descriptor count that disagrees with the header's
    bufs, _ = encode_frame(wire.RESULT, {}, {"x": np.zeros(2, np.int8)})
    raw3 = bytearray(_bytes_of(bufs))
    raw3[6:8] = (2).to_bytes(2, "big")
    with pytest.raises(FrameError, match="count mismatch"):
        decode_frame(bytes(raw3))


# ---------------------------------------------------------------------------
# socket IO: framing survives a real stream, EOF classes are distinct
# ---------------------------------------------------------------------------

def test_send_recv_over_socketpair():
    a, b = _socketpair()
    frames = [
        (wire.HELLO, {"index": 0}, {}),
        (wire.REQUEST, {"req": 1, "tenant": "t0"},
         {"ids": np.arange(33, dtype=np.int64)}),
        (wire.RESULT, {"req": 1, "status": "ok"},
         {"logits": np.random.default_rng(0)
          .normal(size=(8, 5)).astype(np.float32)}),
    ]
    sent, errs = [], []

    def pump():
        try:
            for kind, meta, arrays in frames:
                sent.append(send_frame(a, kind, meta, arrays))
        except OSError as e:                 # pragma: no cover
            errs.append(e)
        finally:
            a.close()                        # clean EOF at a boundary

    t = threading.Thread(target=pump)
    t.start()
    try:
        got = [recv_frame(b) for _ in frames]
        with pytest.raises(ChannelClosed):   # boundary EOF: clean close
            recv_frame(b)
    finally:
        t.join(SOCK_TIMEOUT_S)
        b.close()
    assert not t.is_alive() and not errs, errs
    for (kind, meta, arrays), (k, m, arr, n), n_sent in zip(frames, got,
                                                            sent):
        assert (k, m) == (kind, meta)
        for name in arrays:
            np.testing.assert_array_equal(arr[name], arrays[name])
        assert n == n_sent


def test_mid_frame_eof_is_frame_error():
    a, b = _socketpair()
    try:
        bufs, _ = encode_frame(wire.REQUEST, {"req": 1},
                               {"ids": np.arange(100, dtype=np.int64)})
        raw = _bytes_of(bufs)
        a.sendall(raw[:len(raw) // 2])
        a.close()
        with pytest.raises(FrameError, match="mid-frame"):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_port_frames_read_by_reference_over_a_socket():
    """The port sends, the reference's ``recv_frame`` reads, and back."""
    a, b = _socketpair()
    try:
        ids = np.arange(21, dtype=np.int64)
        n = send_frame(a, wire.REQUEST, {"req": 3}, {"ids": ids})
        k, m, arr, n_got = wire_ref.recv_frame(b)
        assert (k, m, n_got) == (wire.REQUEST, {"req": 3}, n)
        np.testing.assert_array_equal(arr["ids"], ids)
        logits = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
        n = wire_ref.send_frame(b, wire.RESULT, {"req": 3, "status": "ok"},
                                {"logits": logits})
        k, m, arr, n_got = recv_frame(a)
        assert (k, m["status"], n_got) == (wire.RESULT, "ok", n)
        np.testing.assert_array_equal(arr["logits"], logits)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# across packages: the same bytes, either way
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ALL_KINDS)
def test_frames_byte_identical_to_reference(kind):
    rng = np.random.default_rng(kind)
    cases = [({}, {}),
             ({"req": kind, "tenant": "mobile", "deadline_ms": None,
               "f": 0.25, "nested": {"a": [1, 2]}, "s": "τ"}, {})]
    for di in range(len(DTYPES)):
        for ndim in (0, 1, 2, 3):
            cases.append(({"req": di}, _arrays(rng, di, ndim, 5, 3)))
    for meta, arrays in cases:
        bufs, total = encode_frame(kind, meta, arrays)
        bufs_ref, total_ref = wire_ref.encode_frame(kind, meta, arrays)
        assert total == total_ref
        assert [bytes(b) for b in bufs] == [bytes(b) for b in bufs_ref]
        raw = _bytes_of(bufs)
        for dec in (decode_frame, wire_ref.decode_frame):
            k, m, a = dec(raw)
            assert (k, m) == (kind, meta)
            assert set(a) == set(arrays)
            for name, arr in arrays.items():
                assert a[name].dtype == arr.dtype
                # a 0-d array ships as shape (1,) in both packages
                assert a[name].shape == np.ascontiguousarray(arr).shape
                np.testing.assert_array_equal(a[name], arr)


def test_pack_unpack_table_roundtrip():
    t = RoutingTable(
        shard_of_node=np.array([0, 1, -1, 1, 0], dtype=np.int16),
        n_shards=2, version=7)
    meta, arrays = pack_table(t)
    raw = _bytes_of(encode_frame(wire.SWAPPED, meta, arrays)[0])
    _, m, a = decode_frame(raw)
    t2 = unpack_table(m, a)
    assert isinstance(t2, RoutingTable)
    assert (t2.n_shards, t2.version) == (2, 7)
    np.testing.assert_array_equal(t2.shard_of_node, t.shard_of_node)
    assert t2.shard_of_node.dtype == np.int16

    meta, arrays = pack_table(None)
    assert unpack_table(meta, arrays) is None


def test_tables_cross_packages():
    shard = np.array([1, -1, 0, 0, 1, -1], dtype=np.int16)
    port_t = RoutingTable(shard_of_node=shard, n_shards=2, version=3)
    ref_t = RoutingTableRef(shard_of_node=shard, n_shards=2, version=3)
    raw_port = _bytes_of(encode_frame(wire.HELLO_ACK,
                                      *pack_table(port_t))[0])
    raw_ref = _bytes_of(wire_ref.encode_frame(
        wire.HELLO_ACK, *wire_ref.pack_table(ref_t))[0])
    assert raw_port == raw_ref
    # a port table unpacks in the reference, and the other way round
    _, m, a = wire_ref.decode_frame(raw_port)
    got_ref = wire_ref.unpack_table(m, a)
    assert isinstance(got_ref, RoutingTableRef)
    _, m, a = decode_frame(raw_ref)
    got_port = unpack_table(m, a)
    assert isinstance(got_port, RoutingTable)
    for got in (got_ref, got_port):
        assert (got.n_shards, got.version) == (2, 3)
        np.testing.assert_array_equal(got.shard_of_node, shard)
        assert got.shard_of_node.dtype == np.int16
