"""Fixture: the ``moe_forward`` trace root renamed away — its
``TRACE_ROOTS`` row is a ``trace-root-missing`` finding (never imported —
parsed only)."""


def moe_forward_renamed(p, cfg, x):
    return x
