"""The traced window: device activity from ``torch.profiler`` and the
benchmark's own ranges.

The profiler records the device (CUPTI) and not the host's operators.  A
range is delimited on the device by two marker launches
(``torch.cuda._sleep(1)``, one tiny spin kernel each) whose labels the host
logs in launch order; since the stream runs in order, the n-th marker on the
device is the n-th label, whatever thread launched it (the backward runs on
autograd's own thread).  Ranges are installed only for the traced window:
around the model's forward, the loss, the optimizer's ``step`` and
``grad_norm``, and each interpolation kernel wrapper of
``paradis_torch.ops.interp_cuda`` (whose shapes are logged with it).

``Trace`` holds what the metric readers read: device ``events`` as
``(name, start_ns, end_ns)`` without the markers, ``ranges`` as
``(label, start_ns, end_ns)``, ``interp_calls``, ``steps`` (the steps
traced), ``window_s`` (their host-clock span) and ``busy_s``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

MARKER = "spin_kernel"
INTERP_WRAPPERS = {"interp_fwd_cuda": "fwd", "interp_band_fwd_cuda": "fwd",
                   "interp_chunk_fwd_cuda": "fwd", "interp_bwd_cuda": "bwd",
                   "interp_band_bwd_cuda": "bwd", "interp_chunk_bwd_cuda": "bwd"}


@dataclass
class Trace:
    events: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    interp_calls: list = field(default_factory=list)
    steps: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def in_range(events, ranges, label: str):
    """The events that lie inside a range of ``label``."""
    spans = sorted((s, e) for lab, s, e in ranges if lab == label)
    out, i = [], 0
    for ev in events:
        while i < len(spans) and spans[i][1] < ev[1]:
            i += 1
        if i < len(spans) and spans[i][0] <= ev[1] and ev[2] <= spans[i][1]:
            out.append(ev)
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Ranges:
    """Marker-delimited ranges; the labels in launch order."""

    def __init__(self):
        self.labels: list = []
        self.lock = threading.Lock()

    def mark(self, label: str) -> None:
        with self.lock:
            self.labels.append(label)
            torch.cuda._sleep(1)

    @contextlib.contextmanager
    def range(self, label: str):
        self.mark("+" + label)
        try:
            yield
        finally:
            self.mark("-" + label)

    def wrap(self, fn, label: str):
        def wrapped(*args, **kwargs):
            with self.range(label):
                return fn(*args, **kwargs)
        return wrapped

    def spans(self, markers) -> list:
        """``(label, start_ns, end_ns)`` of each range from the marker kernels
        ``(start_ns, end_ns)`` in device order; raises where their count is
        not the labels'."""
        if len(markers) != len(self.labels):
            raise RuntimeError(f"{len(markers)} markers on the device, {len(self.labels)} "
                               f"launched")
        stack: dict = {}
        out = []
        for label, (s, e) in zip(self.labels, sorted(markers)):
            name = label[1:]
            if label[0] == "+":
                stack.setdefault(name, []).append(e)
            else:
                out.append((name, stack[name].pop(), s))
        return out


@contextlib.contextmanager
def installed(ranges: Ranges, model, optimizer=None, loss_fn=None, log=None):
    """The ranges, for the block only: the model's forward, the loss, the
    optimizer's ``step`` and ``grad_norm``, each interpolation wrapper (its
    call's shapes appended to ``log``)."""
    from paradis_torch.ops import interp_cuda

    handles = [model.register_forward_pre_hook(lambda m, a: ranges.mark("+model")),
               model.register_forward_hook(lambda m, a, o: ranges.mark("-model"),
                                           always_call=True)]
    saved = {}
    for name, kind in INTERP_WRAPPERS.items():
        fn = getattr(interp_cuda, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def logged(*args, _fn=fn, _kind=kind, **kwargs):
            field_, pix_y = args[0], args[1]
            if log is not None:
                log.append({"kind": _kind, "n_out": pix_y.numel(),
                            "field_bytes": field_.numel() * field_.element_size(),
                            "elem_bytes": field_.element_size(),
                            "mode": args[-1] if isinstance(args[-1], str)
                            else kwargs.get("mode", "bicubic")})
            with ranges.range("interpolation"):
                return _fn(*args, **kwargs)

        setattr(interp_cuda, name, logged)
    patched = []
    if optimizer is not None:
        for attr in ("step", "grad_norm"):
            setattr(optimizer, attr, ranges.wrap(getattr(optimizer, attr), "optimizer"))
            patched.append((optimizer, attr))
    loss_call = None
    if loss_fn is not None:
        loss_call = type(loss_fn).__call__
        type(loss_fn).__call__ = ranges.wrap(loss_call, "loss")
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for name, fn in saved.items():
            setattr(interp_cuda, name, fn)
        for obj, attr in patched:
            delattr(obj, attr)
        if loss_call is not None:
            type(loss_fn).__call__ = loss_call


def _device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of every device activity in the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def traced(run, steps: int, model, optimizer=None, loss_fn=None) -> Trace:
    """Run ``run()`` (``steps`` steps) under the profiler with the ranges
    installed, and read the trace."""
    from torch.profiler import ProfilerActivity, profile

    ranges, calls = Ranges(), []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with installed(ranges, model, optimizer, loss_fn, calls):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    everything = _device_events(prof)
    markers = [(s, e) for n, s, e in everything if MARKER in n]
    events = [ev for ev in everything if MARKER not in ev[0]]
    return Trace(events=events, ranges=ranges.spans(markers), interp_calls=calls, steps=steps,
                 window_s=window_s, busy_s=union_s((s, e) for _, s, e in events))


def _innermost(ranges):
    """A function from a time (ns) to the label of the innermost range that
    holds it (the one that began last), or ``between ranges``."""
    import bisect

    by_label: dict = {}
    for lab, s, e in ranges:
        by_label.setdefault(lab, []).append((s, e))
    tables = {lab: (sorted(v), [s for s, _ in sorted(v)]) for lab, v in by_label.items()}

    def label(t: int) -> str:
        best = None
        for lab, (spans, starts) in tables.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][1] >= t and (best is None or spans[i][0] > best[0]):
                best = (spans[i][0], lab)
        return "between ranges" if best is None else best[1]

    return label


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed by
    the innermost range open where each begins (what the host was running
    when the device went idle)."""
    by_op: dict = {}
    for name, s, e in tr.events:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    label = _innermost(tr.ranges)
    gaps: dict = {}
    end = None
    for _, s, e in tr.events:
        if end is not None and s > end:
            lab = label(end)
            gaps[lab] = gaps.get(lab, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:200], v] for k, v in rank(by_op)],
            "idle_gaps": [[k, v] for k, v in rank(gaps)]}
