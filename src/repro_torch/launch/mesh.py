"""Meshes of ``torch.distributed`` ranks (port of ``repro.launch.mesh``,
its GNS parts), and a launcher that spawns them.

The reference is single-controller: one program sees a ``(data, model)``
mesh of devices and ``shard_map`` runs a body per device.  The port runs
one process per mesh position instead, PyTorch's own idiom:

* rank ``r = d·M + m`` sits at mesh position ``(d, m)`` of a
  ``(data=D, model=M)`` mesh;
* it holds cache shard ``m`` (the feature-store table's rows
  ``[m·rps, (m+1)·rps)``) and serves data-parallel group ``d``;
* its **model group** is the M ranks of its data-parallel group, one per
  cache shard: the reference's ``psum`` over the cache axis is an
  ``all_reduce`` over it;
* its **data group** is the D ranks that hold its shard, one per
  data-parallel group: gradients and label counts are summed over it.

:func:`make_host_mesh` builds both kinds of group from the process group
the caller initialised (every rank creates every group, in the same
order, as ``dist.new_group`` requires), plus a host group of all ranks on
gloo: the host-side agreements of the feature store (every rank builds
the same cache generation, and swaps it at the same step) reduce CPU
tensors, which only gloo carries.  A ``pod`` axis before ``data`` makes
the reference's multi-pod mesh, and :func:`dryrun_mesh` builds one rank's
view of a production mesh over an in-process ``fake`` world (the
dry-run's; no rank behind it runs).

Serving on a mesh runs several threads per rank that each issue
collectives (a server's loop, a fabric's workers and its watchdog), and
two threads must never share a process group.  :meth:`HostMesh.fork`
gives a thread its own model groups and host group (every rank forks in
the same order), and a :class:`Channel` carries the leader's commands to
the other ranks over such a host group.  Global rank 0 is the *leader*:
clients submit to it, and the other ranks follow its commands.

:func:`run_ranks` is the launcher of the tests and of ``chip_smoke.py``:
it spawns ``data·model`` processes over ``tcp://127.0.0.1``, each on the
device the caller names for it, with the backend the caller names, runs
one function in each and returns what each returned.  A rank that raises,
or a run that outlives its deadline, fails the whole run.
:func:`lead_world` is the launcher of a world that serves until it is
told to stop (an RPC endpoint's): the calling process becomes its rank 0,
the other ranks exit with it, and it exits when one of them fails.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")
LEADER = 0                     # the global rank that takes client calls


class NotLeader(RuntimeError):
    """A client call (``submit``, ``ingest``) on a rank other than the
    mesh's leader, global rank 0: on a mesh only the leader takes
    requests and deltas, and the other ranks follow its commands."""


class MeshDesync(RuntimeError):
    """The ranks of a mesh disagree on what they serve: a follower was
    sent a batch pinned to a generation it cannot reach, or waited past
    its bound for the leader's next step."""


def cache_shard_axis(mesh) -> str:
    """Mesh axis carrying the feature-store cache shards.

    The cache table rides the ``model`` axis: the data-parallel groups each
    consume their own minibatch, so the row shards must live across an
    axis every group spans.  Falls back to the first axis on meshes without
    ``model``."""
    return "model" if "model" in mesh.axis_names else mesh.axis_names[0]


class HostMesh:
    """This rank's view of a ``(data, model)`` mesh of ranks, or of a
    ``(pod, data, model)`` one (``pod`` > 1: the multi-pod dry-run).

    ``shape`` and ``axis_names`` read as a jax mesh's do; ``index(axis)``
    is this rank's coordinate on an axis, ``group(axis)`` the process group
    of the ranks that differ from it only there (on a pod mesh,
    ``group("batch")`` is the ranks that differ only in pod and data: the
    data-parallel group), and ``rank_at(axis, i)`` the global rank at
    coordinate ``i`` of that group.  Rank ``r = (p·D + d)·M + m``."""

    def __init__(self, data: int, model: int, groups: dict,
                 host_group, timeout: Optional[timedelta] = None,
                 pod: int = 1) -> None:
        self.data = data
        self.model = model
        self.pod = pod
        self.rank = dist.get_rank()
        self.axis_names = ("pod",) + AXES if pod > 1 else AXES
        self.shape = {"data": data, "model": model}
        if pod > 1:
            self.shape = {"pod": pod, **self.shape}
        self.size = pod * data * model
        self._coord = {"pod": self.rank // (data * model),
                       "data": self.rank // model % data,
                       "model": self.rank % model}
        self._groups = groups
        self.host_group = host_group
        self.timeout = timeout

    @property
    def leader(self) -> bool:
        """This rank is the mesh's leader (global rank 0)."""
        return self.rank == LEADER

    def fork(self) -> "HostMesh":
        """A view of this mesh with process groups of its own, for one
        thread: new model groups (the sharded K1's ``all_reduce``) and a
        new gloo host group; its data groups are not made (serving never
        sums over the data axis).  Every rank must fork, in one order."""
        groups = {"model": _axis_groups(self.pod, self.data, self.model,
                                        ("model",), self.timeout)}
        return HostMesh(self.data, self.model, groups,
                        new_host_group(self.timeout), self.timeout,
                        pod=self.pod)

    def __repr__(self) -> str:
        pod = f"pod={self.pod}, " if self.pod > 1 else ""
        return (f"HostMesh({pod}data={self.data}, model={self.model}, "
                f"rank={self.rank})")

    def index(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def rank_at(self, axis: str, i: int) -> int:
        c = dict(self._coord, **{axis: i})
        return (c["pod"] * self.data + c["data"]) * self.model + c["model"]


def new_host_group(timeout: Optional[timedelta] = None,
                   backend: str = "gloo"):
    """A new group of every rank (every rank must call it), on gloo
    unless ``backend`` names another."""
    return dist.new_group(list(range(dist.get_world_size())),
                          backend=backend, timeout=timeout)


def _axis_groups(pod: int, data: int, model: int, axes: tuple, timeout):
    """One new group per setting of the coordinates outside ``axes`` (the
    ranks that differ only on ``axes``); returns this rank's."""
    dims = {"pod": pod, "data": data, "model": model}
    rank, mine = dist.get_rank(), None
    fixed = [a for a in ("pod", "data", "model") if a not in axes]
    for key in itertools.product(*(range(dims[a]) for a in fixed)):
        c = dict(zip(fixed, key))
        ranks = []
        for free in itertools.product(*(range(dims[a]) for a in axes)):
            c.update(zip(axes, free))
            ranks.append((c["pod"] * data + c["data"]) * model + c["model"])
        g = dist.new_group(sorted(ranks), timeout=timeout)
        if rank in ranks:
            mine = g
    return mine


def make_host_mesh(data: int = 1, model: int = 1,
                   timeout: Optional[timedelta] = None, *,
                   pod: int = 1, backend: str = "gloo") -> HostMesh:
    """The ``(data, model)`` mesh (``(pod, data, model)`` with ``pod`` >
    1) over the ranks of the initialised process group; raises unless
    there is one of exactly ``pod·data·model`` ranks.  ``timeout`` bounds
    every collective of the groups it makes (and of their forks); None is
    ``torch.distributed``'s default.  ``backend`` is the host group's:
    gloo, or ``fake`` under :func:`dryrun_mesh`."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs an initialised torch.distributed "
            "process group of data·model ranks (run_ranks starts one)")
    world = dist.get_world_size()
    if pod * data * model != world:
        raise ValueError(f"mesh pod={pod} x data={data} x model={model} "
                         f"needs {pod * data * model} ranks; the process "
                         f"group has {world}")
    # every rank creates every group, in one order
    mine = {"model": _axis_groups(pod, data, model, ("model",), timeout),
            "data": _axis_groups(pod, data, model, ("data",), timeout)}
    if pod > 1:
        mine["pod"] = _axis_groups(pod, data, model, ("pod",), timeout)
        mine["batch"] = _axis_groups(pod, data, model, ("pod", "data"),
                                     timeout)
    return HostMesh(data, model, mine, new_host_group(timeout, backend),
                    timeout, pod=pod)


@contextlib.contextmanager
def dryrun_mesh(shape: Sequence[int], rank: int = 0):
    """This rank's view of a mesh of ``shape`` (``(data, model)`` or
    ``(pod, data, model)``) over a ``fake`` world of ``prod(shape)`` ranks
    (``torch.distributed``'s in-process backend: every collective returns
    at once and moves nothing), the counterpart of the reference's
    ``make_production_mesh``.  The world is torn down on exit; a process
    holds one world at a time, so none may be initialised on entry."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(int(s) for s in shape)
    pod, data, model = (1,) * (3 - len(shape)) + shape
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=pod * data * model)
    try:
        yield make_host_mesh(data, model, pod=pod, backend="fake")
    finally:
        dist.destroy_process_group()


class Channel:
    """The leader's commands to the other ranks, over one gloo group that
    only the calling thread uses.

    A command is a kind, ``HEADER`` int64 fields and up to ``width`` int64
    ids, broadcast from the leader in one fixed-size message: the leader
    calls :meth:`send`, every other rank :meth:`recv`, in the same order.
    A follower's ``recv`` is bounded by the group's timeout, and a leader
    with nothing to send sends ``HEARTBEAT`` at its poll interval.

    A serving loop's commands beside ``HEARTBEAT`` and ``STOP``: ``BATCH``
    (bucket, pinned generation, a flag, request count; the ids), ``POLL``
    (a watchdog's decisions) and ``SWAP`` (how many batches were sampled
    before a swap's publish)."""

    HEARTBEAT, STOP, BATCH, POLL, SWAP = range(5)
    HEADER = 4

    def __init__(self, group, width: int) -> None:
        self.group = group
        self.width = int(width)
        self._buf = torch.zeros(2 + self.HEADER + self.width,
                                dtype=torch.int64)

    def send(self, kind: int, fields: Sequence[int] = (),
             ids=None) -> None:
        buf = self._buf
        buf.zero_()
        n = 0 if ids is None else len(ids)
        if n > self.width or len(fields) > self.HEADER:
            raise ValueError(f"command of {n} ids and {len(fields)} fields "
                             f"exceeds {self.width} / {self.HEADER}")
        buf[0], buf[1] = int(kind), n
        if len(fields):
            buf[2:2 + len(fields)] = torch.as_tensor(
                [int(f) for f in fields], dtype=torch.int64)
        if n:
            buf[2 + self.HEADER:2 + self.HEADER + n] = torch.as_tensor(
                ids, dtype=torch.int64)
        dist.broadcast(buf, src=LEADER, group=self.group)

    def recv(self) -> tuple:
        """``(kind, fields, ids)`` of the leader's next command."""
        buf = self._buf
        dist.broadcast(buf, src=LEADER, group=self.group)
        n = int(buf[1])
        fields = [int(v) for v in buf[2:2 + self.HEADER]]
        ids = buf[2 + self.HEADER:2 + self.HEADER + n].numpy().copy()
        return int(buf[0]), fields, ids


def broadcast_object(obj, group):
    """The leader's ``obj`` on every rank (pickled over ``group``)."""
    box = [obj if dist.get_rank() == LEADER else None]
    dist.broadcast_object_list(box, src=LEADER, group=group)
    return box[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank, world, port, data, model, device, backend, target, args,
               timeout_s, results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_host_mesh(data, model,
                                  timedelta(seconds=timeout_s))
            out = _resolve(target)(mesh, dev, *args)
            dist.barrier(group=mesh.host_group)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(target: str, *, data: int, model: int, devices: Sequence,
              backend: str, args: tuple = (), timeout_s: float = 300.0
              ) -> list:
    """Run ``target`` (``"module:function"``) as ``fn(mesh, device,
    *args)`` on each rank of a ``(data, model)`` mesh; returns the ranks'
    results in rank order.

    ``devices`` names one device per rank (``["cuda:0"] * n`` puts every
    rank on one card); ``backend`` is the process group's.  The ranks are
    spawned processes that rendezvous over ``tcp://127.0.0.1`` on a free
    port.  A rank that raises fails the run with its traceback; a run past
    ``timeout_s`` seconds is killed and raises ``TimeoutError``.  Every
    process is stopped before this returns or raises."""
    world = data * model
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, port, data, model, str(devices[r]), backend, target, args,
        timeout_s, results)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{target}: {world - len(out)} of {world} ranks still "
                    f"running after {timeout_s} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # a rank died without reporting: give its message a
                    # moment to arrive, then fail
                    try:
                        rank, ok, val = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"{target}: rank {dead[0]} exited with "
                            f"{procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"{target}: rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# a world led by this process (an endpoint's)
# ---------------------------------------------------------------------------

_PR_SET_PDEATHSIG = 1


def _die_with(parent: int) -> None:
    """End this process when ``parent`` does: the kernel's parent-death
    signal where there is one (Linux), and a thread that watches the
    parent's pid either way (it also covers a parent gone before the
    signal was set)."""
    import ctypes
    import os
    import signal
    import threading
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                                 signal.SIGKILL)
    except (OSError, AttributeError):
        pass

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True,
                     name="mesh-parent-watch").start()


def _follower_main(rank, world, port, data, model, device, backend, target,
                   args, timeout_s, parent) -> None:
    import os
    import sys
    _die_with(parent)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, world, False,
                              timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        try:
            _resolve(target)(make_host_mesh(data, model, timeout), dev,
                             *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class World:
    """The ranks :func:`lead_world` spawned beside this process (rank 0)
    and this rank's mesh; until :meth:`close`, a thread ends this process
    when one of them fails."""

    def __init__(self, procs: list) -> None:
        import threading
        self.mesh: Optional[HostMesh] = None
        self.procs = procs
        self._closing = threading.Event()
        threading.Thread(target=self._watch, daemon=True,
                         name="mesh-world-watch").start()

    def _watch(self) -> None:
        import os
        import sys
        while not self._closing.wait(0.1):
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0):
                    sys.stderr.write(f"mesh: rank {r} of the world exited "
                                     f"with {p.exitcode}; its leader "
                                     f"exits\n")
                    sys.stderr.flush()
                    os._exit(1)

    @property
    def pids(self) -> list:
        """The followers' process ids, rank 1 first."""
        return [p.pid for p in self.procs]

    def close(self, timeout_s: float = 60.0) -> list:
        """Tear down this rank's process group and wait for the followers
        to exit (their targets returned); kills any still running after
        ``timeout_s``.  Returns their exit codes, rank 1 first."""
        self._closing.set()
        dist.destroy_process_group()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        return [p.exitcode for p in self.procs]


def lead_world(target: str, *, data: int, model: int, device,
               backend: str, args: tuple = (), timeout_s: float = 300.0
               ) -> World:
    """Make this process rank 0, the leader, of a ``(data, model)`` world
    whose other ranks are spawned processes on ``device``, each running
    ``target`` (``"module:function"``) as ``fn(mesh, device, *args)`` and
    exiting when it returns.  Returns once this rank's mesh is made (every
    rank makes its groups in one order).  Unlike :func:`run_ranks`, the
    ranks live as long as their work, not a deadline:

    * the rendezvous is a ``TCPStore`` this process holds on a port the OS
      chose, bound from the start, so no other world can take it;
    * a follower exits with its leader, also on a SIGKILL (the parent-death
      signal, and a thread that watches the parent);
    * a follower that fails (raises, or is killed) ends this process with
      exit code 1, its traceback on the shared stderr: a world that lost a
      rank cannot go on.

    ``timeout_s`` bounds the rendezvous and every collective of the
    world's groups."""
    import os
    world = data * model
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=timeout,
                          wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, daemon=True, args=(
        r, world, store.port, data, model, str(device), backend, target,
        args, timeout_s, os.getpid())) for r in range(1, world)]
    for p in procs:
        p.start()
    out = World(procs)
    dist.init_process_group(backend, store=store, rank=0, world_size=world,
                            timeout=timeout)
    out.mesh = make_host_mesh(data, model, timeout)
    return out


def failed_ranks(ok: bool, group) -> list:
    """The ranks of ``group`` whose ``ok`` is false, on every rank (every
    rank of the group calls it, as a collective)."""
    t = torch.zeros(dist.get_world_size(group), dtype=torch.int32)
    t[dist.get_rank(group)] = int(not ok)
    dist.all_reduce(t, group=group)
    return [r for r, bad in enumerate(t.tolist()) if bad]
