"""The port's runtime lock sanitizer (``repro_torch.analysis``) against the
reference's (``repro.analysis.runtime``).

``tests/conftest.py`` sets ``REPRO_LOCK_SANITIZER=1`` before any import, so
both sanitizers are armed for the whole suite.  The same class, decorated
once by each package, must behave the same under the same calls: locks
wrapped in ``TrackedLock`` at assignment, unguarded writes of a guarded
attribute raising ``LockDisciplineError``, ``@holds_lock`` methods entered
without their lock raising, and the first inverted acquisition order
raising ``LockOrderError``.  The port's threaded classes carry tracked
locks here, so every ``test_torch_*`` file runs them under the checks.
"""
import threading

import numpy as np
import pytest

import repro.analysis as ref_an
import repro_torch.analysis as port_an

PACKAGES = pytest.mark.parametrize("an", [ref_an, port_an],
                                   ids=["reference", "port"])


def _box(an):
    @an.guarded_by("_lock", "items", writes_only=("published",))
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []
            self.published = 0

        def put(self, x):
            with self._lock:
                self.items = self.items + [x]
                self.published += 1

        def put_unlocked(self, x):
            self.items = self.items + [x]

        @an.holds_lock("_lock")
        def _count_locked(self):
            return len(self.items)

        def count(self):
            with self._lock:
                return self._count_locked()

    return Box


def test_port_sanitizer_is_armed_for_the_suite():
    assert port_an.sanitizer_enabled()
    assert ref_an.sanitizer_enabled()
    # the port's own runtime, not the reference's
    assert port_an.TrackedLock is not ref_an.TrackedLock
    assert port_an.guarded_by.__module__ == "repro_torch.analysis.runtime"


@PACKAGES
def test_guarded_writes_and_holds_lock(an):
    box = _box(an)()
    assert isinstance(box._lock, an.TrackedLock)
    assert box._lock.label == "Box._lock"
    box.put(1)
    assert box.count() == 1
    with pytest.raises(an.LockDisciplineError, match="unguarded write"):
        box.put_unlocked(2)
    with pytest.raises(an.LockDisciplineError, match="requires '_lock'"):
        box._count_locked()
    # a write from another thread while this one holds the lock raises
    # there, not here
    errs = []

    def writer():
        try:
            box.published = 5
        except an.LockDisciplineError as e:
            errs.append(e)

    with box._lock:
        t = threading.Thread(target=writer)
        t.start()
        t.join()
    assert len(errs) == 1 and box.published == 1


@PACKAGES
def test_lock_order_inversion_raises(an):
    an.reset_lock_order()

    @an.guarded_by("_a", "x")
    class A:
        def __init__(self):
            self._a = threading.Lock()
            self.x = 0

    @an.guarded_by("_b", "y")
    class B:
        def __init__(self):
            self._b = threading.Lock()
            self.y = 0

    a, b = A(), B()
    with a._a:
        with b._b:
            pass
    with b._b:
        with pytest.raises(an.LockOrderError, match="lock-order cycle"):
            a._a.acquire()
    # the refused acquisition released the lock it had taken
    assert not a._a.locked()
    an.reset_lock_order()
    with b._b:                      # a fresh graph accepts either order
        with a._a:
            pass
    an.reset_lock_order()


def test_same_calls_raise_the_same_errors_in_both():
    """One random sequence of locked, unlocked and holds_lock calls on each
    package's Box: the same outcome at every step."""
    rng = np.random.default_rng(0)
    boxes = {an: _box(an)() for an in (ref_an, port_an)}
    for step in range(60):
        op = int(rng.integers(3))
        outcomes = []
        for an, box in boxes.items():
            try:
                if op == 0:
                    box.put(step)
                elif op == 1:
                    box.put_unlocked(step)
                else:
                    box._count_locked()
                outcomes.append("ok")
            except an.LockDisciplineError:
                outcomes.append("discipline")
        assert outcomes[0] == outcomes[1], (step, op, outcomes)
    assert boxes[ref_an].items == boxes[port_an].items


def test_port_threaded_classes_carry_tracked_locks():
    """The store, the server's meter, the delta buffer and the fabric's
    parts are built with tracked locks under the armed sanitizer."""
    from repro_torch.featurestore import CacheConfig, FeatureStore
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.serve import FairScheduler, Router, ServeMeter
    from repro_torch.stream import DeltaBuffer
    ds = get_dataset("tiny", seed=0)
    store = FeatureStore(ds.features, ds.graph, CacheConfig(fraction=0.1),
                         device="cpu")
    locks = {"FeatureStore._lock": store._lock,
             "ServeMeter.lock": ServeMeter().lock,
             "DeltaBuffer._lock": DeltaBuffer(10, 4)._lock,
             "FairScheduler._slock": FairScheduler()._slock,
             "Router._rlock": Router([0, 1], 2)._rlock}
    for label, lk in locks.items():
        assert isinstance(lk, port_an.TrackedLock), label
        assert lk.label == label
