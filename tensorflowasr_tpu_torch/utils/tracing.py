"""Spans and launch counts of the program's phases, requests and kernels.

A span names a stretch of host work: a training step and its phases
(``train.step`` ⊃ ``train.zero_grad``, ``train.forward``, ``train.loss``,
``train.backward``, ``train.update``), a request (``recognize`` ⊃
``recognize.encode``, ``recognize.decode``) and each kernel wrapper's
launch block (``kernel.<kernel>.<pass>``, :func:`kernel`). Spans record
only inside :func:`collect`, which is the one way to turn them on::

    with tracing.collect() as records:
        trainer.train_step(state, batch)
    # records: one Span per span opened, in the order they opened

Outside it :func:`span` returns one shared null context after a single
check of a module-level flag: it records nothing, allocates nothing and
touches neither the profiler nor CUDA. Inside it each span records its
name, ids, thread, host times and the shapes and dtypes of the tensors
passed to it; where ``torch.profiler`` is also running, the span opens a
``record_function`` of its name, so that its range lies on the profiler's
clock beside the device operations it launched. Under
``torch.compiler.is_exporting()`` a span is always the null context, so an
exported program holds no profiler operation.

Parents: a span's parent is the innermost span open on its own thread.
Autograd runs the kernels' backward passes on a thread of its own (one per
card); a span opened on a thread with no open span takes as parent the
process-wide open phase, the innermost span open on the thread that holds
the outermost span (the one that called ``backward()``). The outermost
span (``train.step``, ``recognize``) starts a new root: every span under it
carries its id in ``root``.

:data:`launches` counts the kernel launches by span name, on or off: a
kernel span adds one when its block closes without raising, and the
wrappers open it only where they launch.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

launches: collections.Counter = collections.Counter()  # kernel launches by span name (``kernel.ff.fwd``, ...); clear() resets

_on = False  # inside collect()
_records: list | None = None
_ids = itertools.count(1)
_local = threading.local()  # .stack: the spans open on this thread, innermost last
_phase = None  # the innermost span open on the thread that holds the outermost span


class _Null:
    """The span of a run that does not collect."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


NULL = _Null()


class _Count:
    """A kernel span of a run that does not collect: counts the launch at a clean close."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            launches[self.name] += 1
        return False


_counts: dict = {}  # one _Count per kernel span name


class Span:
    """One span's record: ``name``; ``id``, ``parent`` (None for an outermost span) and ``root`` (the outermost
    span's id); ``thread`` (``threading.get_ident()``); host ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``;
    ``end_ns`` None while open); the ``shapes`` and ``dtypes`` of the tensors passed in."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "shapes", "dtypes", "_count", "_owns_phase", "_rf", "_prev")

    def __init__(self, name: str, tensors: tuple, count: bool):
        self.name, self._count = name, count
        ts = [t for t in tensors if t is not None]
        self.shapes = [tuple(t.shape) for t in ts]
        self.dtypes = [str(t.dtype).replace("torch.", "") for t in ts]
        self.id = next(_ids)
        self.parent = self.root = self.end_ns = self._rf = self._prev = None
        self._owns_phase = False
        self.thread = threading.get_ident()
        self.start_ns = 0

    def __enter__(self):
        global _phase
        stack = _stack()
        if stack:
            up, self._owns_phase = stack[-1], stack[-1]._owns_phase
        else:
            up, self._owns_phase = _phase, _phase is None
        if up is not None:
            self.parent, self.root = up.id, up.root
        else:
            self.root = self.id
        if self._owns_phase:
            self._prev, _phase = _phase, self
        stack.append(self)
        if _records is not None:
            _records.append(self)
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        global _phase
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(kind, value, tb)
            self._rf = None
        stack = _stack()
        if self in stack:  # a span left open by a raise inside it closes with its parent
            del stack[stack.index(self):]
        if self._owns_phase and _phase is self:
            _phase = self._prev
        if self._count and kind is None:
            launches[self.name] += 1
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _exporting() -> bool:
    return torch.compiler.is_exporting()


def span(name: str, *tensors):
    """The span ``name`` as a context manager; ``tensors`` (None allowed) give the recorded shapes and dtypes."""
    if not _on or _exporting():
        return NULL
    return Span(name, tensors, False)


def kernel(name: str, *tensors):
    """A kernel wrapper's span around its launch block, which adds one to ``launches[name]`` at a clean close, whether
    or not spans are collected. Open it only where the wrapper launches."""
    if not _on or _exporting():
        c = _counts.get(name)
        if c is None:
            c = _counts[name] = _Count(name)
        return c
    return Span(name, tensors, True)


class Phases:
    """Spans that follow one another at a hook's marks: opens ``first``; ``mark(p)`` calls ``on_phase(p)``, closes the
    open span and opens ``after[p]`` (none where ``after`` has no name for ``p``); :meth:`close` closes what is open."""

    __slots__ = ("_on_phase", "_after", "_open")

    def __init__(self, on_phase, first: str, after: dict):
        self._on_phase, self._after = on_phase, after
        self._open = span(first)
        self._open.__enter__()

    def mark(self, phase: str) -> None:
        if self._on_phase is not None:
            self._on_phase(phase)
        self._open.__exit__(None, None, None)
        nxt = self._after.get(phase)
        self._open = NULL if nxt is None else span(nxt)
        self._open.__enter__()

    def close(self) -> None:
        self._open.__exit__(None, None, None)
        self._open = NULL


@contextlib.contextmanager
def collect():
    """Turns spans on while open; yields the list of :class:`Span` records made meanwhile (in opening order), which the
    caller reduces or writes once it closes. Nested, the inner one collects alone until it closes."""
    global _on, _records, _phase
    saved = (_on, _records, _phase)
    records: list = []
    _on, _records, _phase = True, records, None
    try:
        yield records
    finally:
        _on, _records, _phase = saved
