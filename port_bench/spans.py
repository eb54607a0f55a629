"""The program's own spans over the traced window, and what they charge.

``paradis_torch`` names its work (``paradis_torch.utils.tracing``: the train
step, its forward, loss, backward and optimizer, the model's layers, the
rollout's steps).  ``traced`` is ``trace.traced`` with the program's
recording on around ``run()``: its ``Trace`` (``SpanTrace``) carries the
same fields, read the same way (markers, ranges, device events), and three
more, read from the same profiler:

- ``spans``: the program's ``Span`` records (ns on the Unix clock, which the
  profiler stamps its events on);
- ``launches``: the CUDA runtime's (or driver's) call that launched each
  device event, by correlation id: ``(name, start_ns, end_ns, thread)``;
- ``correlations``: each device event's correlation id, in ``events``' order.

The device-only profiler stamps every runtime call with one thread (1, on
the card's torch 2.11), so a launch's thread is read from the spans: the
thread of the innermost span open at the launch, the one that began last.
While autograd's thread runs the backward the main thread waits inside its
``backward`` span and launches nothing, so at any instant one thread
launches.

Idle time: a gap runs from the end of the device's busy union to the next
device event's start.  Each nanosecond of it is charged to the innermost
span open at that instant on the thread that launched the event ending the
gap; where that thread had no span open, to the innermost span of the
thread of the step's root span; with neither, to ``outside``.  A span on
another thread than its root's hangs, for the metrics, under the root
thread's innermost span open at its start (the interpolation's backward
under ``backward``).

These readings come from the traced window, so they carry the profiler's
host cost (and the recording's): host times read longer, and device idle
more, than in an untraced step.

Without spans (a program that records none) every reader returns None.

``python3 -m port_bench.spans --workload <cell> --seed <n> --seconds <s>``
runs the cell as ``port_bench.run --trace 1`` does, with this ``traced`` in
the traced window, and prints ``run``'s result line with ``program_spans``
added: the metrics of ``METRICS`` and the clock's checks (``clock_checks``).
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from dataclasses import dataclass, field

import torch

from port_bench import trace

OUTSIDE = "outside"
# the prefix of the host events that are CUDA runtime or driver calls
# (``cudaLaunchKernel``, ``cuLaunchKernel``, ...): the profiler's own host
# events (its "Activity Buffer Request") carry correlation ids too
RUNTIME = "cu"

# the metrics these spans give, as BENCHMARK.json's ``per_layer`` would list them
_TRAIN, _FORECAST = ["train-1.40625deg-b1"], ["forecast-1.40625deg-b1"]
METRICS = [
    {"name": "optim_host_ms.train", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "optimizer", "moves": "train_samples_per_s", "workloads": _TRAIN},
    {"name": "optim_idle_ms.train", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "optimizer", "moves": "train_samples_per_s", "workloads": _TRAIN},
    {"name": "optim_launches.train", "unit": "launches", "better": "lower",
     "source": "device_trace", "layer": "optimizer", "moves": "train_samples_per_s",
     "workloads": _TRAIN},
    {"name": "backward_host_ms.train", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "host dispatch", "moves": "train_samples_per_s", "workloads": _TRAIN},
    {"name": "backward_idle_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "host dispatch", "moves": "train_samples_per_s",
     "workloads": _TRAIN},
    {"name": "dispatch_ms.forecast", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "host dispatch", "moves": "forecast_steps_per_s", "workloads": _FORECAST},
    {"name": "advection_ms.forecast", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model", "moves": "forecast_steps_per_s",
     "workloads": _FORECAST},
    {"name": "diffusion_ms.forecast", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model", "moves": "forecast_steps_per_s",
     "workloads": _FORECAST},
]


@dataclass
class SpanTrace(trace.Trace):
    spans: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    correlations: list = field(default_factory=list)
    window_ns: tuple = ()     # the window's start and end on the spans' clock


def traced(run, steps: int, model, optimizer=None, loss_fn=None) -> SpanTrace:
    """``trace.traced`` with the program's spans recorded and the runtime's
    launches read; ``window_ns`` is the window on the spans' clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        from paradis_torch.utils.tracing import recording
    except ImportError:    # a program that records no spans
        recording = contextlib.nullcontext

    ranges, calls = trace.Ranges(), []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.installed(ranges, model, optimizer, loss_fn, calls), \
                recording() as spans:
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            window_ns = (t0_ns, time.time_ns())
    device, host = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            s = e.start_ns()
            device.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU and e.name().startswith(RUNTIME):
            s = e.start_ns()
            host[e.correlation_id()] = (e.name(), s, s + e.duration_ns(), e.start_thread_id())
    device.sort(key=lambda t: t[1])
    markers = [(s, e) for n, s, e, _ in device if trace.MARKER in n]
    kept = [ev for ev in device if trace.MARKER not in ev[0]]
    events = [ev[:3] for ev in kept]
    correlations = [ev[3] for ev in kept]
    return SpanTrace(events=events, ranges=ranges.spans(markers), interp_calls=calls,
                     steps=steps, window_s=window_s,
                     busy_s=trace.union_s((s, e) for _, s, e in events), spans=list(spans or ()),
                     launches={c: host[c] for c in correlations if c in host},
                     correlations=correlations, window_ns=window_ns)


def _segments(spans) -> tuple:
    """``(starts, ends, ids)``: the stretches of time over which one span is
    the innermost open one (the one that began last) among ``spans``."""
    bounds = sorted([(s.start_ns, 1, s) for s in spans] + [(s.end_ns, 0, s) for s in spans],
                    key=lambda b: (b[0], b[1]))
    starts, ends, ids = [], [], []
    open_: list = []
    last = None
    for t, kind, s in bounds:
        if open_ and last is not None and t > last:
            top = max(open_, key=lambda o: (o.start_ns, o.id))
            if ids and ids[-1] == top.id and ends[-1] == last:
                ends[-1] = t
            else:
                starts.append(last)
                ends.append(t)
                ids.append(top.id)
        if kind:
            open_.append(s)
        else:
            open_.remove(s)
        last = t
    return starts, ends, ids


class Timeline:
    """Which of a recording's spans was open when, on each thread and on
    all of them."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        roots = [s for s in spans if s.parent is None]
        self.root_thread = roots[0].thread if roots else None
        by_thread: dict = {}
        for s in spans:
            by_thread.setdefault(s.thread, []).append(s)
        self.threads = {t: _segments(v) for t, v in by_thread.items()}
        self.all = _segments(spans)
        self._chains: dict = {}

    @staticmethod
    def _at(segs, t: int):
        starts, ends, ids = segs
        i = bisect.bisect_right(starts, t) - 1
        return ids[i] if i >= 0 and t <= ends[i] else None

    def innermost(self, t: int, thread=None):
        """The id of the innermost span open at ``t`` on ``thread`` (on any
        thread, the one that began last, where None), or None."""
        segs = self.all if thread is None else self.threads.get(thread)
        return None if segs is None else self._at(segs, t)

    def names(self, sid) -> frozenset:
        """The names of a span and of the spans above it; a span whose
        parent is on another thread hangs under the innermost span of the
        root thread open at its start."""
        if sid is None:
            return frozenset()
        if sid not in self._chains:
            s = self.by_id[sid]
            up = s.parent if s.parent in self.by_id else None
            if up is not None and self.by_id[up].thread != s.thread:
                up = self.innermost(s.start_ns, self.by_id[up].thread) or up
            self._chains[sid] = frozenset((s.name,)) | self.names(up)
        return self._chains[sid]

    def _cover(self, a: int, b: int, thread, out: dict) -> list:
        """Charge what spans of ``thread`` cover of ``[a, b)`` into ``out``;
        return the parts they leave uncovered."""
        segs = self.threads.get(thread)
        if segs is None:
            return [(a, b)]
        starts, ends, ids = segs
        rest, t = [], a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(starts) and starts[i] < b:
            lo, hi = max(starts[i], t), min(ends[i], b)
            if hi > lo:
                if lo > t:
                    rest.append((t, lo))
                out[ids[i]] = out.get(ids[i], 0) + hi - lo
                t = hi
            i += 1
        if t < b:
            rest.append((t, b))
        return rest

    def charge(self, a: int, b: int, launched_in, out: dict) -> None:
        """Charge the idle ``[a, b)`` ended by an event launched inside span
        ``launched_in`` (an id or None) into ``out`` by the rule above."""
        thread = root_thread = self.root_thread
        if launched_in is not None:
            s = self.by_id[launched_in]
            thread = s.thread
            root_thread = self.by_id[s.root].thread if s.root in self.by_id else thread
        rest = self._cover(a, b, thread, out)
        for lo, hi in rest:
            for x, y in (self._cover(lo, hi, root_thread, out) if root_thread != thread
                         else [(lo, hi)]):
                out[OUTSIDE] = out.get(OUTSIDE, 0) + y - x


def launch_spans(tr: SpanTrace, tl: Timeline) -> list:
    """For each device event, the id of the span open at its launch (None
    where none was, or where no launch was recorded)."""
    out = []
    for c in tr.correlations:
        launch = tr.launches.get(c)
        out.append(None if launch is None else tl.innermost(launch[1]))
    return out


def charged_idle(tr: SpanTrace, tl: Timeline, launched: list) -> dict:
    """Idle ns by span id (and ``outside``) over the window's gaps."""
    out: dict = {}
    end = None
    for (_, s, e), sid in zip(tr.events, launched):
        if end is not None and s > end:
            tl.charge(end, s, sid, out)
        end = e if end is None else max(end, e)
    return out


def _has_spans(ctx) -> SpanTrace | None:
    tr = ctx["trace"]
    if not getattr(tr, "spans", None) or tr.steps <= 0:
        return None
    return tr


def host_ms(ctx, name: str) -> float | None:
    """Host ms a step inside the spans named ``name``."""
    tr = _has_spans(ctx)
    if tr is None:
        return None
    inside = [s.end_ns - s.start_ns for s in tr.spans if s.name == name]
    return sum(inside) / 1e6 / tr.steps if inside else None


def idle_ms(ctx, name: str) -> float | None:
    """Device idle ms a step charged to ``name`` or the spans under it."""
    tr = _has_spans(ctx)
    if tr is None or not any(s.name == name for s in tr.spans):
        return None
    tl = Timeline(tr.spans)
    charged = charged_idle(tr, tl, launch_spans(tr, tl))
    ns = sum(v for k, v in charged.items() if k != OUTSIDE and name in tl.names(k))
    return ns / 1e6 / tr.steps


def _launched_under(ctx, name: str):
    tr = _has_spans(ctx)
    if tr is None or not any(s.name == name for s in tr.spans):
        return None, None
    tl = Timeline(tr.spans)
    return tr, [ev for ev, sid in zip(tr.events, launch_spans(tr, tl)) if name in tl.names(sid)]


def launches_in(ctx, name: str) -> float | None:
    """Kernels a step (copies and fills left out) launched inside ``name``
    or the spans under it."""
    tr, evs = _launched_under(ctx, name)
    if tr is None:
        return None
    return sum(trace.is_kernel(n) for n, _, _ in evs) / tr.steps


def device_ms_in(ctx, name: str) -> float | None:
    """Device ms a step of the events launched inside ``name`` or the spans
    under it."""
    tr, evs = _launched_under(ctx, name)
    if tr is None:
        return None
    return sum(e - s for _, s, e in evs) / 1e6 / tr.steps


def clock_checks(tr: SpanTrace) -> dict:
    """How far the spans and the device trace agree: the share of device
    events matched to a launch, the share of those launched inside a span,
    the events that start before their launch (name, lag, the launch call
    and its ns) and the least lag, the idle gaps' total against the
    window's idle and the window's two ends that no gap holds (before the
    first device event, after the last), and the share of the gaps charged
    to a span, with the charged total.  Then where the time went, ms a step
    by span name: the idle charged, the host's self time
    (``tracing.self_ns``), the host's time inside the runtime's launch calls
    under each name (a launch call that waits for room in the device's queue
    holds the host to the device's pace) and the device time of the events
    launched under each name."""
    from paradis_torch.utils.tracing import self_ns

    if not tr.spans or not tr.events:
        return {}
    tl = Timeline(tr.spans)
    launched = launch_spans(tr, tl)
    matched = [(ev, tr.launches[c]) for ev, c in zip(tr.events, tr.correlations)
               if c in tr.launches]
    lags = [ev[1] - launch[1] for ev, launch in matched]
    charged = charged_idle(tr, tl, launched)
    total = sum(charged.values())
    gaps, end = 0, None
    for _, s, e in tr.events:
        if end is not None and s > end:
            gaps += s - end
        end = e if end is None else max(end, e)
    by_name: dict = {}
    for k, v in charged.items():
        key = OUTSIDE if k == OUTSIDE else tl.by_id[k].name
        by_name[key] = by_name.get(key, 0) + v
    own: dict = {}
    for sid, ns in self_ns(tr.spans).items():
        name = tl.by_id[sid].name
        own[name] = own.get(name, 0) + ns
    in_calls: dict = {}
    for _, s, e, _ in tr.launches.values():
        for name in tl.names(tl.innermost(s)) or (OUTSIDE,):
            in_calls[name] = in_calls.get(name, 0) + (e - s)
    device: dict = {}
    for (_, s, e), sid in zip(tr.events, launched):
        for name in tl.names(sid) or (OUTSIDE,):
            device[name] = device.get(name, 0) + (e - s)
    return {"events": len(tr.events), "matched_share": len(matched) / len(tr.events),
            "in_span_share": (sum(sid is not None for sid in launched) / len(matched)
                              if matched else None),
            "before_launch": [(ev[0][:80], lag, launch[0], launch[2] - launch[1])
                              for (ev, launch), lag in zip(matched, lags) if lag < 0],
            "least_lag_ns": min(lags) if lags else None,
            "gaps_ms": gaps / 1e6, "window_idle_ms": (tr.window_s - tr.busy_s) * 1e3,
            "lead_ms": (tr.events[0][1] - tr.window_ns[0]) / 1e6 if tr.window_ns else None,
            "tail_ms": (tr.window_ns[1] - end) / 1e6 if tr.window_ns else None,
            "charged_ms": total / 1e6,
            "named_share": 1 - charged.get(OUTSIDE, 0) / total if total else None,
            "idle_ms_a_step_by_span": {k: v / 1e6 / tr.steps for k, v in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])},
            "host_self_ms_a_step_by_span": {k: v / 1e6 / tr.steps for k, v in
                                            sorted(own.items(), key=lambda kv: -kv[1])},
            "launch_call_ms_a_step_under": {k: v / 1e6 / tr.steps
                                            for k, v in in_calls.items()},
            "device_ms_a_step_under": {k: v / 1e6 / tr.steps for k, v in device.items()}}


def main(argv=None) -> int:
    import argparse
    from unittest import mock

    from port_bench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    kept = {}

    def keeping(*a, **k):
        kept["trace"] = traced(*a, **k)
        return kept["trace"]

    with mock.patch.object(trace, "traced", keeping):
        out = run.run_cell(args.workload, args.seed, args.seconds, True)
    tr = kept["trace"]
    ctx = {"trace": tr}
    values = {m["name"]: run.reader(m["name"])(ctx) for m in METRICS
              if args.workload in m["workloads"]}
    out["program_spans"] = {"metrics": {k: {"value": v, "unit": next(
        m["unit"] for m in METRICS if m["name"] == k)} for k, v in values.items()},
        "checks": clock_checks(tr)}
    return run.print_result(out)


if __name__ == "__main__":
    raise SystemExit(main())
