"""Client side of the transport: one TCP connection to one endpoint (port
of ``repro.rpc.channel``).

A :class:`Channel` owns the socket, a receiver thread, and the liveness
bookkeeping the fabric watchdog consumes:

- **connect** retries with exponential backoff and *deterministic* jitter
  (seeded rng — chaos tests replay bit-for-bit);
- **send** serializes frame writes under a send lock and books
  ``bytes_rpc_tx`` on the channel's TrafficMeter;
- **call** is the request/response helper for control RPCs (HELLO,
  STATS_REQ): a per-request deadline bounds the wait, correlation rides
  the reserved ``rpc_id`` meta key;
- the receiver thread dispatches HEARTBEAT frames into lock-free-readable
  liveness fields (``beat_age`` mirrors the in-proc worker contract:
  local silence + the remote worker's own reported beat age) and hands
  every other frame to the owner's ``on_frame`` callback.

Disconnect (EOF, RST, frame garbage) fails all pending calls and flips
``rpc_connected`` — the proxy's sender thread exits on seeing it, which is
exactly the "thread gone" signal the watchdog's DEAD path keys on.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.analysis import TrackedLock, guarded_by, sanitizer_enabled

from . import wire


class RpcError(RuntimeError):
    """Transport-level failure: connect exhausted, channel closed, call
    timed out, or the peer reported an error."""


class _CallSlot:
    """One outstanding control RPC (event + first-wins result)."""

    __slots__ = ("_ev", "_reply", "_err")

    def __init__(self):
        self._ev = threading.Event()
        self._reply = None
        self._err: Optional[BaseException] = None

    def complete(self, reply) -> None:
        self._reply = reply
        self._ev.set()

    def fail(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def wait(self, timeout: float):
        if not self._ev.wait(timeout):
            raise TimeoutError("rpc call timed out")
        if self._err is not None:
            raise self._err
        return self._reply


@guarded_by("_clock", "_pending_rpc",
            writes_only=("rpc_connected", "hb_mono", "hb_remote_age_s"))
class Channel:
    """One coordinator-side connection; thread-safe send + receiver loop.

    ``rpc_connected`` / ``hb_mono`` / ``hb_remote_age_s`` follow the
    writes_only snapshot contract: written under ``_clock``, read lock-free
    by the watchdog via :meth:`beat_age` and by the proxy's ``alive``.
    """

    def __init__(self, name: str = "rpc", meter=None,
                 on_frame: Optional[Callable] = None, seed: int = 0):
        self.name = name
        self.meter = meter                  # TrafficMeter (this channel's)
        self.on_frame = on_frame
        self._clock = threading.Lock()
        # send serialization is its own lock (never held across recv);
        # wrapped so the sanitizer's lock-order graph sees it
        lk = threading.Lock()
        self._send_mu = (TrackedLock(lk, "Channel._send_mu")
                         if sanitizer_enabled() else lk)
        self._pending_rpc: Dict[int, _CallSlot] = {}
        self.rpc_connected = False
        self.hb_mono = time.monotonic()
        self.hb_remote_age_s = 0.0
        self.tx_frames = 0                  # send-lock holders only
        self.rx_frames = 0                  # receiver thread only
        self._rpc_seq = 0                   # call() issuers under _send_mu
        self._sock: Optional[socket.socket] = None
        self._recv_thread: Optional[threading.Thread] = None
        self._jitter = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def connect(self, host: str, port: int, *, timeout_s: float = 5.0,
                retries: int = 5, backoff_s: float = 0.05) -> None:
        """Dial with bounded retries + exponential backoff.  Jitter comes
        from the channel's seeded rng, so a replayed chaos run retries on
        the exact same schedule."""
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            try:
                s = socket.create_connection((host, port), timeout=timeout_s)
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = s
                with self._clock:
                    self.rpc_connected = True
                    self.hb_mono = time.monotonic()
                t = threading.Thread(target=self._recv_loop, daemon=True,
                                     name=f"gns-rpc-recv-{self.name}")
                self._recv_thread = t
                t.start()
                return
            except OSError as e:
                last = e
                if attempt < retries:
                    delay = (backoff_s * (2 ** attempt)
                             * (1.0 + 0.25 * float(self._jitter.random())))
                    time.sleep(delay)
        raise RpcError(f"connect to {host}:{port} failed after "
                       f"{retries + 1} attempts: {last}")

    # ------------------------------------------------------------------
    def send(self, kind: int, meta=None, arrays=None) -> int:
        """Write one frame (serialized against other senders)."""
        with self._send_mu:
            sock = self._sock
            if sock is None or not self.rpc_connected:
                raise RpcError(f"channel {self.name} is closed")
            try:
                n = wire.send_frame(sock, kind, meta, arrays)
            except OSError as e:
                self._mark_dead()
                raise RpcError(f"send on {self.name} failed: {e}") from e
            self.tx_frames += 1
            if self.meter is not None:
                self.meter.bytes_rpc_tx += n
            return n

    def call(self, kind: int, meta=None, arrays=None,
             timeout: float = 10.0):
        """Request/response control RPC with a per-request deadline.
        Returns ``(kind, meta, arrays)`` of the reply."""
        with self._send_mu:
            self._rpc_seq += 1
            rid = self._rpc_seq
        slot = _CallSlot()
        with self._clock:
            self._pending_rpc[rid] = slot
        md = dict(meta or {})
        md["rpc_id"] = rid
        try:
            self.send(kind, md, arrays)
            return slot.wait(timeout)
        finally:
            with self._clock:
                self._pending_rpc.pop(rid, None)

    # ------------------------------------------------------------------
    def beat_age(self, now: float) -> float:
        """Watchdog liveness signal: local heartbeat silence plus the
        remote worker's own reported beat age, so a stalled remote compute
        loop surfaces through a perfectly healthy TCP connection."""
        return max(now - self.hb_mono, 0.0) + self.hb_remote_age_s

    def close(self) -> None:
        self._mark_dead()

    # ------------------------------------------------------------------
    def _mark_dead(self) -> None:
        with self._clock:
            self.rpc_connected = False
            pend, self._pending_rpc = dict(self._pending_rpc), {}
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for slot in pend.values():
            slot.fail(RpcError(f"channel {self.name} disconnected"))

    def _recv_loop(self) -> None:
        sock = self._sock
        try:
            while sock is not None:
                kind, meta, arrays, n = wire.recv_frame(sock)
                self.rx_frames += 1
                if self.meter is not None:
                    self.meter.bytes_rpc_rx += n
                if kind == wire.HEARTBEAT:
                    with self._clock:
                        self.hb_mono = time.monotonic()
                        self.hb_remote_age_s = float(
                            meta.get("beat_age_s", 0.0))
                    continue
                rid = meta.get("rpc_id")
                if rid is not None:
                    with self._clock:
                        slot = self._pending_rpc.pop(rid, None)
                    if slot is not None:
                        slot.complete((kind, meta, arrays))
                        continue
                cb = self.on_frame
                if cb is not None:
                    cb(kind, meta, arrays)
        except (wire.ChannelClosed, wire.FrameError, OSError):
            pass
        finally:
            self._mark_dead()
