"""Fixture: lock-discipline violations (never imported — parsed only)."""
import threading

from repro_torch.analysis import guarded_by, holds_lock


@guarded_by("_lock", "_shadow", "_pending", writes_only=("_live",))
class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._shadow = None
        self._pending = None
        self._live = None
        self._thread = threading.Thread(target=self._refresh)
        self._thread.start()

    def _refresh(self):
        with self._lock:
            self._shadow = object()
        self._pending = True         # lock-unguarded-write

    def peek(self):
        return self._shadow          # lock-unguarded-read

    def swap(self):
        with self._lock:
            self._live = self._shadow   # both under the lock: clean
            self._shadow = None

    @holds_lock("_lock")
    def _drop_locked(self):
        self._pending = None         # the caller holds the lock: clean

    def publish(self, gen):
        self._live = gen             # lock-unguarded-write (writes_only attr)


def poll(store):
    return store._shadow             # lock-external-access


def poll_locked(store):
    with store._lock:
        return store._shadow         # under the same base's lock: clean
