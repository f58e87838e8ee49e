"""The port's ``gnscheck``: lock-discipline annotations, the runtime lock
sanitizer and (``python -m repro_torch.analysis``) the static passes: trace
purity, lock discipline, generation pinning, retrace hazards and
TrafficMeter pairing.

Only the runtime symbols are re-exported here — every threaded module of
the port imports this at module load, so it must stay stdlib-only and must
NOT pull the AST passes in."""
from .runtime import (LockDisciplineError, LockOrderError, TrackedLock,
                      enable_sanitizer, guarded_by, holds_lock,
                      reset_lock_order, sanitizer_enabled)

__all__ = [
    "guarded_by", "holds_lock", "enable_sanitizer", "sanitizer_enabled",
    "reset_lock_order", "TrackedLock", "LockDisciplineError",
    "LockOrderError",
]
