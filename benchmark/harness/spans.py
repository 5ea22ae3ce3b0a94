"""The span sub-window of a traced run: ``torch.profiler`` with the
program's spans collected (``tensorflowasr_tpu_torch/utils/tracing.py``)
over a few steps or requests, reduced to what each span launched on the
device.

Each device operation is given to the innermost program span open at the
host call that launched it (the runtime call that shares the operation's
correlation id; where the trace holds none, the host operation the
profiler linked it to). A span opened on a thread with no open span of
its own (autograd's backward thread) hangs under the innermost span open
on another thread at its start, as the program's own records nest it.
Per span name, per step or request: its count and its device extent, from
the first operation launched inside it or any span nested in it to the end
of the last (idle inside it included). The busy time of the operations
launched inside a ``kernel.*`` span (the hand-written kernels) and of the
rest (cuBLAS, elementwise, copies and casts, the optimizer's ``foreach``
kernels: the library ops); each idle gap given to the innermost span open
at its midpoint; per kernel span name, its launches, device time and least
time (``harness/kernel_work.py``, from the shapes its records hold).

:func:`reduce` takes a neutral form of the trace (so the CPU tests can give
it synthetic events); :func:`from_profiler` makes that form from
``prof.events()``; :func:`profile` runs the sub-window. The per-layer
readers of the ``spans`` field are at the end.
"""

from __future__ import annotations

import bisect
import collections
import time

from . import kernel_work

KERNEL = "kernel."  # the prefix of the hand-written kernels' spans
RUNTIME = ("cuda", "cu")  # host runtime calls that launch device work (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...)


class Trace:
    """The sub-window in neutral form, times in µs on the profiler's clock: ``spans`` [(name, thread, start, end)],
    ``launches`` {correlation id: (thread, time)} (the host call that launched each operation), ``ops`` [(correlation id,
    start, end)] (kernels, copies and sets), ``links`` {correlation id: (thread, time)} (the host operation the profiler
    linked an operation to, a fallback for an operation whose launch the trace lacks), ``names`` {correlation id: the
    operation's name}."""

    def __init__(self, spans, launches, ops, links=None, names=None):
        self.spans, self.launches, self.ops = list(spans), dict(launches), list(ops)
        self.links, self.names = dict(links or {}), dict(names or {})


def from_profiler(events, names: set) -> Trace:
    """A :class:`Trace` of ``prof.events()``: the spans whose names the program recorded (``names``), the runtime calls
    and the device operations (the device-side ranges of annotations left out, as ``harness/trace.py`` does)."""
    from torch.autograd import DeviceType

    spans, launches, ops, cpu_ops, linked, op_names = [], {}, [], {}, {}, {}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                ops.append((e.id, start, end))
                op_names[e.id] = e.name
                link = getattr(e, "linked_correlation_id", 0)
                if link:
                    linked[e.id] = link
        elif e.name in names:
            spans.append((e.name, e.thread, start, end))
        elif e.name.startswith(RUNTIME) and not e.name.startswith("cudnn"):
            launches[e.id] = (e.thread, start)
        else:
            cpu_ops[e.id] = (e.thread, start)
    links = {corr: cpu_ops[op] for corr, op in linked.items() if op in cpu_ops}
    return Trace(spans, launches, ops, links, op_names)


class _Index:
    """Innermost-span lookup: per thread the spans by start, each with its parent on that thread."""

    def __init__(self, spans: list):
        self.spans = spans
        self.by_thread = collections.defaultdict(list)
        for i in sorted(range(len(spans)), key=lambda i: (spans[i][2], -spans[i][3])):
            self.by_thread[spans[i][1]].append(i)
        self.starts = {th: [spans[i][2] for i in idx] for th, idx in self.by_thread.items()}
        self.parent = [None] * len(spans)
        for th, idx in self.by_thread.items():
            stack = []
            for i in idx:
                while stack and spans[stack[-1]][3] < spans[i][3]:
                    stack.pop()
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
        for i in range(len(spans)):  # a thread's outermost span hangs under the innermost span open elsewhere at its start
            if self.parent[i] is None:
                self.parent[i] = self.anywhere(spans[i][2], exclude=spans[i][1])

    def on_thread(self, thread, t):
        idx = self.by_thread.get(thread)
        if not idx:
            return None
        k = bisect.bisect_right(self.starts[thread], t) - 1
        i = idx[k] if k >= 0 else None
        while i is not None and not (self.spans[i][2] <= t <= self.spans[i][3]):
            i = self.parent[i] if self.parent[i] is not None and self.spans[self.parent[i]][1] == thread else None
        return i

    def anywhere(self, t, exclude=None):
        """The innermost span open at ``t`` on any thread (the latest started), or None."""
        best = None
        for th in self.by_thread:
            if th != exclude:
                i = self.on_thread(th, t)
                if i is not None and (best is None or self.spans[i][2] > self.spans[best][2]):
                    best = i
        return best

    def at(self, thread, t):
        i = self.on_thread(thread, t)
        return i if i is not None else self.anywhere(t)

    def chain(self, i):
        while i is not None:
            yield i
            i = self.parent[i]


def _union(intervals) -> tuple[float, list]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce(trace: Trace, n: int, wall_s: float, records=(), launched=None) -> dict:
    """The ``spans`` field of a traced run's record from the sub-window's :class:`Trace` over ``n`` steps or requests
    and ``wall_s`` seconds. ``records``: the program's span records of the same window (their shapes give each kernel
    call's least time, paired with the trace's spans of the name in order). ``launched``: ``tracing.launches``' growth
    over the window, kept beside the spans' counts. Times in ms, per step or request where the key says so."""
    spans = trace.spans
    index = _Index(spans)
    owner, by_link, lost = [], 0, 0
    for corr, start, end in trace.ops:
        at = trace.launches.get(corr)
        if at is None:
            at = trace.links.get(corr)
            by_link += at is not None
        if at is None:
            lost += 1
            owner.append(None)
        else:
            owner.append(index.at(*at))
    first, last, busy_in = [None] * len(spans), [None] * len(spans), [0.0] * len(spans)
    kernel_iv, library_iv, library_by_name = [], [], collections.Counter()
    for (corr, start, end), i in zip(trace.ops, owner):
        chain = list(index.chain(i))
        if i is not None:
            busy_in[i] += end - start
        if any(spans[j][0].startswith(KERNEL) for j in chain):
            kernel_iv.append((start, end))
        else:
            library_iv.append((start, end))
            library_by_name[trace.names.get(corr, "?")[:100]] += (end - start) * 1e-3
        for j in chain:
            first[j] = start if first[j] is None else min(first[j], start)
            last[j] = end if last[j] is None else max(last[j], end)
    by_name = collections.defaultdict(lambda: {"count": 0.0, "extent_ms": 0.0, "busy_ms": 0.0})
    for i, (name, _, _, _) in enumerate(spans):
        row = by_name[name]
        row["count"] += 1 / n
        row["busy_ms"] += busy_in[i] * 1e-3 / n
        if first[i] is not None:
            row["extent_ms"] += (last[i] - first[i]) * 1e-3 / n
    busy_us, merged = _union(kernel_iv + library_iv)
    idle = collections.defaultdict(lambda: [0, 0.0])
    for (_, end), (start, _) in zip(merged, merged[1:]):
        i = index.anywhere(0.5 * (start + end))
        row = idle[spans[i][0] if i is not None else "no span"]
        row[0] += 1
        row[1] += (start - end) * 1e-3
    shapes = collections.defaultdict(list)
    for r in sorted(records, key=lambda r: r.start_ns):
        if r.name.startswith(KERNEL):
            shapes[r.name].append(r)
    kernels = {}
    for name in sorted({s[0] for s in spans if s[0].startswith(KERNEL)}):
        mine = [i for i, s in enumerate(spans) if s[0] == name]
        mine.sort(key=lambda i: spans[i][2])
        recs = shapes.get(name, [])
        least = [kernel_work.least_s(name, r.shapes, r.dtypes) for r in recs] if len(recs) == len(mine) else [None]
        kernels[name] = {"launches": len(mine), "device_ms": sum(busy_in[i] for i in mine) * 1e-3,
                         "least_ms": None if any(v is None for v in least) else sum(least) * 1e3}
    return {"n": n, "wall_s": wall_s, "busy_s": busy_us * 1e-6, "kernel_busy_s": _union(kernel_iv)[0] * 1e-6,
            "library_busy_s": _union(library_iv)[0] * 1e-6, "ops": len(trace.ops), "ops_by_link": by_link, "ops_unattributed": lost,
            "by_name": {k: dict(v) for k, v in sorted(by_name.items())}, "kernels": kernels,
            "idle_by_span": {k: [v[0], v[1]] for k, v in sorted(idle.items(), key=lambda kv: -kv[1][1])},
            "library_top_ms": [[k, v] for k, v in library_by_name.most_common(10)],
            "launched": dict(sorted((launched or {}).items()))}


def profile(torch, fn, n: int) -> dict:
    """Runs ``fn(i)`` for i < n under the profiler with the program's spans collected, between two synchronises; the
    reduced ``spans`` field (its ``wall_s`` beside the plain sub-window's is the cost of collecting). Raises ImportError
    where the program has no spans."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tensorflowasr_tpu_torch.utils import tracing

    torch.cuda.synchronize()
    before = collections.Counter(tracing.launches)
    with tracing.collect() as records, torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = collections.Counter(tracing.launches)
    launched.subtract(before)
    trace = from_profiler(prof.events(), {r.name for r in records})
    return reduce(trace, n, wall, records, {k: v for k, v in launched.items() if v})


# ---- readers of the ``spans`` field (None where the record is not of ``kind`` or lacks what they read) ----


def _spans(record: dict, kind: str):
    if record.get("kind") != kind:
        return None
    return record.get("spans")


def extent_ms(record: dict, kind: str, name: str):
    """The device extent of the span ``name`` per step or request, in ms."""
    s = _spans(record, kind)
    row = None if s is None else s["by_name"].get(name)
    return None if row is None or row["count"] <= 0 else row["extent_ms"]


def kernel_roofline(record: dict, kind: str):
    """Σ least time over Σ device time of the kernel spans whose work is counted (``kernel_work.py``), in %."""
    s = _spans(record, kind)
    if s is None:
        return None
    rows = [k for k in s["kernels"].values() if k["least_ms"] is not None]
    device = sum(k["device_ms"] for k in rows)
    return None if device <= 0 else 100.0 * sum(k["least_ms"] for k in rows) / device


def library_share(record: dict, kind: str):
    """The busy time of the operations launched outside every kernel span over all busy time, in %."""
    s = _spans(record, kind)
    if s is None or s["busy_s"] <= 0:
        return None
    return 100.0 * s["library_busy_s"] / s["busy_s"]
