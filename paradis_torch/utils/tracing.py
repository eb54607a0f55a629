"""Spans of the program's own work, on the profiler's clock.

``span(name)`` brackets a piece of the program's work::

    with span("optimizer"):
        optimizer.step()

Recording is off by default.  Off, ``span`` reads one module-level flag and
returns one shared object whose ``__enter__`` and ``__exit__`` do nothing: it
allocates nothing, formats no string and reads no clock.  It is off too
while ``torch.compile`` or ``torch.export`` traces the code
(``torch.compiler.is_compiling()``), so an exported graph is the same
whether recording is on or off.

``recording()`` turns recording on for its block and yields the list that
the spans land in as they close, sorted by start at the block's end.
Nothing is written while the work runs.  A ``Span`` holds its name, its id,
the id of the span that caused it, the id of its root span (one train step
or one rollout: every span under it shares it), the OS thread
(``threading.get_native_id()``) and its start and end in ``time.time_ns()``,
the clock ``torch.profiler`` stamps its events on.  A per-thread stack gives
each span its parent.  A thread with no open span takes the open root span
of the thread that turned recording on as its parent: the backward that
autograd runs on its own thread hangs under the train step.  With
``annotate``, for a profiler that records the host's operators, each span
also enters a ``record_function`` of its name, so that it shows in the
profiler's trace and holds the operators issued inside it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass

import torch


@dataclass(slots=True)
class Span:
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int = 0


class _Off:
    """The span of recording off: nothing on entry, nothing on exit."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """One recording: its spans, ids, per-thread stacks, and the root span
    open on the thread that turned it on."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.spans: list = []
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.owner = threading.get_ident()
        self.root: Span | None = None


_recorder: _Recorder | None = None   # the recording in progress; None while off


class _On:
    __slots__ = ("rec", "name", "span", "annotation")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name, self.annotation = rec, name, None

    def __enter__(self):
        rec = self.rec
        stack = getattr(rec.local, "stack", None)
        if stack is None:
            stack = rec.local.stack = []
        sid = next(rec.ids)
        if stack:
            parent, root = stack[-1].id, stack[-1].root
        elif rec.root is not None:
            parent = root = rec.root.id
        else:
            parent, root = None, sid
        s = Span(self.name, sid, parent, root, threading.get_native_id(), time.time_ns())
        if not stack and parent is None and threading.get_ident() == rec.owner:
            rec.root = s
        stack.append(s)
        self.span = s
        if rec.annotate:
            self.annotation = torch.autograd.profiler.record_function(self.name)
            self.annotation.__enter__()
        return s

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        s, rec = self.span, self.rec
        s.end_ns = time.time_ns()
        rec.local.stack.pop()
        if rec.root is s:
            rec.root = None
        rec.spans.append(s)
        return False


def span(name: str):
    """A context manager that records ``name`` over its block while
    recording is on (see the module's docstring)."""
    if _recorder is None or torch.compiler.is_compiling():
        return _OFF
    return _On(_recorder, name)


@contextlib.contextmanager
def recording(annotate: bool = False):
    """Record the spans of the block; yields the list of ``Span`` that they
    land in as they close, sorted by start once the block ends.
    ``annotate``: also enter a ``record_function`` of each span's name (for
    a profiler that records the host's operators).  Recordings do not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the program's spans are already being recorded")
    rec = _Recorder(annotate)
    _recorder = rec
    try:
        yield rec.spans
    finally:
        _recorder = None
        rec.spans.sort(key=lambda s: (s.start_ns, s.id))


def is_recording() -> bool:
    return _recorder is not None


def self_ns(spans) -> dict:
    """Each span's self time in ns by id: its length less the part of it
    that its children (on any thread) cover."""
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, end), min(b, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
