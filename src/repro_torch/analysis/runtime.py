"""Runtime concurrency annotations and the debug-mode lock sanitizer (port
of ``repro.analysis.runtime``, stdlib only).

Two annotations form the contract every threaded class of the port writes
down next to its code:

* :func:`guarded_by` — class decorator declaring which instance attributes
  are protected by which lock attribute::

      @guarded_by("_lock", "_shadow", "_thread", writes_only=("_live",))
      class FeatureStore: ...

  ``writes_only`` attributes follow the publish-subscribe idiom: every WRITE
  must hold the lock (so the reference swap is atomic w.r.t. other writers)
  while lock-free snapshot READS are the documented contract.

* :func:`holds_lock` — method decorator asserting the method is only ever
  entered with the named lock already held (callee-side of a split-locking
  protocol).

The sanitizer — on when the ``REPRO_LOCK_SANITIZER`` environment variable
is set to anything but ``""`` or ``"0"`` when this module is imported (the
test suite's ``conftest.py`` sets it), or after ``enable_sanitizer()`` —
wraps the named locks in ownership-tracking proxies, makes any unguarded
*write* to a guarded attribute raise :class:`LockDisciplineError` at the
faulting line, and records the global lock-acquisition order, raising
:class:`LockOrderError` the first time two locks are ever taken in opposite
orders.  Its state (the order graph, the switch) is this module's own: the
reference's sanitizer does not see the port's locks, nor this one the
reference's.
"""
from __future__ import annotations

import functools
import os
import threading
from typing import Dict, Tuple

__all__ = [
    "guarded_by", "holds_lock", "enable_sanitizer", "sanitizer_enabled",
    "reset_lock_order", "TrackedLock", "LockDisciplineError", "LockOrderError",
]


class LockDisciplineError(AssertionError):
    """A guarded attribute was written without holding its declared lock."""


class LockOrderError(AssertionError):
    """Two locks were acquired in an order that closes a wait-for cycle."""


_enabled = os.environ.get("REPRO_LOCK_SANITIZER", "") not in ("", "0")


def enable_sanitizer(on: bool = True) -> None:
    """Globally switch the runtime checks (call before instances exist:
    locks are wrapped at assignment time, in ``__init__``)."""
    global _enabled
    _enabled = on


def sanitizer_enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------------------
# lock-order graph (labels are `Class.attr`; edges mean "held while taking")
# ---------------------------------------------------------------------------

_held = threading.local()          # per-thread stack of lock labels
_order_mu = threading.Lock()
_order: Dict[str, set] = {}        # label -> labels acquired while holding it


def reset_lock_order() -> None:
    """Clear the recorded acquisition-order graph (test isolation helper)."""
    with _order_mu:
        _order.clear()


def _reaches(src: str, dst: str) -> bool:
    """True if ``dst`` is reachable from ``src`` in the order graph."""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_order.get(n, ()))
    return False


def _record_order(prev: str, label: str) -> None:
    if prev == label:
        # same-label nesting is two *instances* of one class (per-instance
        # ordering is out of scope for a class-granular graph) — skip rather
        # than flag every legitimate pairwise use as a self-cycle
        return
    with _order_mu:
        edges = _order.setdefault(prev, set())
        if label in edges:
            return
        if _reaches(label, prev):
            raise LockOrderError(
                f"lock-order cycle: acquired {label!r} while holding "
                f"{prev!r}, but {prev!r} has (transitively) been acquired "
                f"while holding {label!r} — a deadlock waiting for the "
                f"right interleaving")
        edges.add(label)


class TrackedLock:
    """Ownership/ordering proxy over a ``threading.Lock`` (or RLock).

    Supports the subset of the lock protocol the repo uses (``with``,
    ``acquire``/``release``, ``locked``) plus :meth:`held_by_current_thread`
    for the sanitizer's ownership asserts.
    """

    __slots__ = ("_lock", "label", "_owner")

    def __init__(self, lock, label: str):
        self._lock = lock
        self.label = label
        self._owner = None          # thread ident holding it (approximate
                                    # for RLocks: last acquirer)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            stack = getattr(_held, "stack", None)
            if stack is None:
                stack = _held.stack = []
            try:
                if stack:
                    _record_order(stack[-1], self.label)
            except LockOrderError:
                self._lock.release()
                raise
            self._owner = threading.get_ident()
            stack.append(self.label)
        return ok

    def release(self) -> None:
        stack = getattr(_held, "stack", None)
        if stack and self.label in stack:
            # remove the most recent occurrence (supports non-LIFO release)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.label:
                    del stack[i]
                    break
        if self._owner == threading.get_ident():
            self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.label!r}, owner={self._owner})"


_RAW_LOCK_TYPES: Tuple[type, ...] = (type(threading.Lock()),
                                     type(threading.RLock()))


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------

def guarded_by(lock_name: str, *attrs: str, writes_only: Tuple[str, ...] = ()):
    """Class decorator: declare ``attrs`` protected by ``self.<lock_name>``.

    ``attrs`` require the lock for reads AND writes; ``writes_only`` attrs
    require it for writes (lock-free snapshot reads are the contract).  The
    static pass enforces both; the runtime sanitizer enforces writes (plain
    attribute reads cannot be intercepted without a prohibitive
    ``__getattribute__`` override).
    """

    def deco(cls):
        guarded = dict(getattr(cls, "__gnscheck_guarded__", {}))
        for a in attrs:
            guarded[a] = (lock_name, "rw")
        for a in writes_only:
            guarded[a] = (lock_name, "w")
        cls.__gnscheck_guarded__ = guarded
        lock_attrs = {ln for ln, _ in guarded.values()}

        orig_setattr = cls.__setattr__

        def __setattr__(self, name, value):
            if _enabled:
                if (name in lock_attrs
                        and isinstance(value, _RAW_LOCK_TYPES)):
                    value = TrackedLock(
                        value, f"{type(self).__name__}.{name}")
                info = guarded.get(name)
                if (info is not None
                        and self.__dict__.get("_gnscheck_ready", False)):
                    lk = self.__dict__.get(info[0])
                    if (isinstance(lk, TrackedLock)
                            and not lk.held_by_current_thread()):
                        raise LockDisciplineError(
                            f"unguarded write to {type(self).__name__}."
                            f"{name} (guarded by {info[0]!r}) on thread "
                            f"{threading.current_thread().name!r}")
            orig_setattr(self, name, value)

        cls.__setattr__ = __setattr__

        orig_init = cls.__init__

        @functools.wraps(orig_init)
        def __init__(self, *a, **k):
            orig_init(self, *a, **k)
            # construction happens-before publication: checks arm only
            # after __init__ returns
            object.__setattr__(self, "_gnscheck_ready", True)

        cls.__init__ = __init__
        return cls

    return deco


def holds_lock(lock_name: str):
    """Method decorator: the caller must already hold ``self.<lock_name>``.

    The static pass treats the whole body as lock-dominated; in sanitizer
    mode entry without ownership raises :class:`LockDisciplineError`.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *a, **k):
            if _enabled:
                lk = getattr(self, lock_name, None)
                if (isinstance(lk, TrackedLock)
                        and not lk.held_by_current_thread()):
                    raise LockDisciplineError(
                        f"{type(self).__name__}.{fn.__name__} requires "
                        f"{lock_name!r} held on entry")
            return fn(self, *a, **k)

        wrapper.__gnscheck_holds_lock__ = lock_name
        return wrapper

    return deco
