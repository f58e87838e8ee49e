"""Reduce a ``torch.profiler`` trace of the window to the numbers the
per-layer metrics and the result's ``breakdown`` read.

Device time is the union of the intervals of every device operation
(kernels, copies, sets) inside the window, so operations that overlap on
two streams count once.  An idle gap is a stretch of the window with no
device operation; each quarter of it is named by what the main thread
was doing at the quarter's middle: the innermost harness span
(``gnsbench.*``) and, inside it, the outermost ``aten::`` operation, if
any.
"""
from __future__ import annotations

import collections
import dataclasses

WINDOW_SPAN = "gnsbench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float              # the traced window, from its span
    busy_s: float                # union of device operations inside it
    gaps: list                   # [(start_ns, end_ns)], longest first
    idle: dict                   # what the main thread did -> idle seconds
    op_seconds: dict             # device operation name -> seconds
    op_counts: dict              # device operation name -> launches

    def kernel(self, fragment: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``fragment``."""
        names = [n for n in self.op_seconds if fragment in n]
        return (sum(self.op_seconds[n] for n in names),
                sum(self.op_counts[n] for n in names))


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _is_annotation(ev) -> bool:
    """A host span's shadow on the device's timeline (the profiler draws
    each ``record_function`` there too): not device work."""
    marked = getattr(ev, "is_user_annotation", None)
    return ev.name().startswith("gnsbench.") or bool(
        marked is not None and marked())


def union(intervals: list) -> list:
    """Merged, sorted ``[(start, end)]`` of possibly overlapping ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def summarize(events) -> TraceSummary:
    """The window's device time, its idle gaps and the device operations,
    from the profiler's raw events (``prof.profiler.kineto_results
    .events()``).  The thread that opened the window's span is the main
    thread."""
    events = list(events)
    spans = [ev for ev in events if ev.name() == WINDOW_SPAN
             and not _is_device(ev)]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} {WINDOW_SPAN} spans in the trace")
    main = spans[0].start_thread_id()
    w0 = spans[0].start_ns()
    w1 = w0 + spans[0].duration_ns()
    device, host = [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            if not _is_annotation(ev):
                device.append((s, e, ev.name()))
        elif ev.start_thread_id() == main and ev.name() != WINDOW_SPAN:
            host.append((s, e, ev.name()))
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device
               if e > w0 and s < w1]
    busy = union([(s, e) for s, e, _ in clipped])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    host.sort()
    # each quarter of a gap goes to what the main thread was doing at the
    # quarter's middle (a gap's start is where the device ran dry, often
    # inside the step's final sync, not what kept it idle)
    points = [(s + (2 * q + 1) * (e - s) / 8, (e - s) / 4e9)
              for s, e in gaps for q in range(4)]
    idle = collections.Counter()
    for label, (_, secs) in zip(_label(host, [p for p, _ in points]),
                                points):
        idle[label] += secs
    gaps.sort(key=lambda g: g[0] - g[1])
    secs = collections.Counter()
    counts = collections.Counter()
    for s, e, n in clipped:
        secs[n] += (e - s) / 1e9
        counts[n] += 1
    return TraceSummary(window_s=(w1 - w0) / 1e9,
                        busy_s=sum(e - s for s, e in busy) / 1e9,
                        gaps=gaps, idle=dict(idle), op_seconds=dict(secs),
                        op_counts=dict(counts))


def _label(host: list, times: list) -> list:
    """What the main thread was doing at each of ``times`` (ascending): the
    innermost harness span open then and the outermost ``aten::``
    operation open then.  One sweep over the host events (sorted by
    start), keeping the stack of those still open."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        open_ = [h for h in stack if h[1] >= t]
        spans = [h[2] for h in open_ if h[2].startswith("gnsbench.")]
        ops = [h[2] for h in open_ if h[2].startswith("aten::")]
        label = spans[-1] if spans else "none"
        out.append(f"{label}/{ops[0]}" if ops else label)
    return out


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle seconds by what the host was doing, each with
    at most ``top`` entries."""
    ops = sorted(summary.op_seconds.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary.idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
