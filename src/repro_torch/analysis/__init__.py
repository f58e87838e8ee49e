"""Lock-discipline annotations and the runtime lock sanitizer (port of the
runtime half of ``repro.analysis``; stdlib only, so every threaded module of
the port can import it).  The reference's static passes are not ported."""
from .runtime import (LockDisciplineError, LockOrderError, TrackedLock,
                      enable_sanitizer, guarded_by, holds_lock,
                      reset_lock_order, sanitizer_enabled)

__all__ = [
    "guarded_by", "holds_lock", "enable_sanitizer", "sanitizer_enabled",
    "reset_lock_order", "TrackedLock", "LockDisciplineError",
    "LockOrderError",
]
