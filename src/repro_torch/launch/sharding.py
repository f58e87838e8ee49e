"""The mesh scope and the batch-axis rule (port of the GNS parts of
``repro.launch.sharding``).

:func:`use_mesh` puts a :class:`~repro_torch.launch.mesh.HostMesh` in
scope for the calling thread and :func:`current_mesh` reads it: the model
routes its layer 0 through the sharded kernels when a mesh is in scope,
and runs the single-device path otherwise.  :func:`batch_axes` names the
mesh axes that carry the logical batch (the data-parallel axes).  The LM
zoo's rule tables are not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

# logical batch -> physical mesh axes (pods are extra data parallelism)
_BATCH = ("pod", "data")

_state = threading.local()


def current_mesh():
    """The mesh :func:`use_mesh` put in scope on this thread, or None."""
    return getattr(_state, "mesh", None)


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the logical batch."""
    return tuple(a for a in _BATCH if a in mesh.axis_names)


@contextlib.contextmanager
def use_mesh(mesh):
    """Thread-local mesh scope (``None`` scopes no mesh)."""
    prev: Optional[object] = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
