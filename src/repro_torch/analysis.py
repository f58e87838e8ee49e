"""Lock-discipline annotations, stdlib only.

``repro.analysis`` checks its ``@guarded_by`` / ``@holds_lock`` contracts
statically and, under its sanitizer, at run time.  The port keeps the same
annotations on the classes it copies, so the contracts stay written down
next to the code, but these decorators record nothing and change nothing:
they return the class or function they are given.
"""
from __future__ import annotations


def guarded_by(lock_name: str, *attrs: str, writes_only: tuple = ()):
    """Class decorator: ``attrs`` are read and written under
    ``self.<lock_name>``; ``writes_only`` attrs are written under it."""

    def deco(cls):
        return cls

    return deco


def holds_lock(lock_name: str):
    """Method decorator: the caller already holds ``self.<lock_name>``."""

    def deco(fn):
        return fn

    return deco
