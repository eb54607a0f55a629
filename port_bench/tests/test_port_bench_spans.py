"""The program's spans against the device trace, on synthetic spans,
launches and kernels: the idle-charging rule, each reader of
``port_bench/spans.py``'s ``METRICS`` and the clock's checks."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from paradis_torch.utils.tracing import Span
from port_bench import spans
from port_bench.run import reader

ROOT = Path(__file__).resolve().parents[2]
MAIN, AUTOGRAD = 10, 20


def _trace():
    """One step: the forward, a backward whose interpolation runs on
    autograd's thread, the optimizer; then a launch outside every span and a
    kernel whose launch was not recorded."""
    sp = [Span("train_step", 1, None, 1, MAIN, 0, 1000),
          Span("forward", 2, 1, 1, MAIN, 10, 200),
          Span("model", 3, 2, 1, MAIN, 20, 190),
          Span("backward", 4, 1, 1, MAIN, 300, 600),
          Span("interpolation_bwd", 5, 1, 1, AUTOGRAD, 400, 450),
          Span("optimizer", 6, 1, 1, MAIN, 650, 950),
          Span("grad_norm", 7, 6, 1, MAIN, 660, 700),
          Span("normuon", 8, 6, 1, MAIN, 750, 940)]
    kernels = [("k1", 50, 250, 1, 40), ("k2", 320, 420, 2, 310), ("k3", 460, 500, 3, 430),
               ("Memcpy DtoD", 700, 710, 4, 690), ("k5", 960, 980, 5, 900),
               ("k6", 1100, 1200, 6, 1050), ("k7", 1210, 1220, 99, None)]
    return spans.SpanTrace(
        events=[k[:3] for k in kernels], steps=1, window_s=1.3e-6,
        busy_s=sum(e - s for _, s, e, _, _ in kernels) / 1e9, spans=sp,
        launches={c: ("cudaLaunchKernel", t, t + 5, 1) for _, _, _, c, t in kernels
                  if t is not None},
        correlations=[k[3] for k in kernels], window_ns=(-20, 1225))


def test_the_innermost_span_and_a_backward_span_under_backward():
    tl = spans.Timeline(_trace().spans)
    assert tl.root_thread == MAIN
    assert tl.innermost(100) == 3 and tl.innermost(250) == 1 and tl.innermost(1050) is None
    assert tl.innermost(420) == 5 and tl.innermost(420, MAIN) == 4
    assert tl.innermost(420, AUTOGRAD) == 5 and tl.innermost(470, AUTOGRAD) is None
    assert tl.names(5) == {"interpolation_bwd", "backward", "train_step"}
    assert tl.names(8) == {"normuon", "optimizer", "train_step"}


def test_idle_is_charged_by_the_rule():
    tr = _trace()
    tl = spans.Timeline(tr.spans)
    charged = spans.charged_idle(tr, tl, spans.launch_spans(tr, tl))
    # each gap: (launching thread's spans, then the root thread's, then outside)
    assert charged == {1: 50 + 50 + 10 + 20, 4: 20 + 10 + 100, 5: 30, 6: 10 + 40 + 10,
                       7: 40, 8: 190, spans.OUTSIDE: 100 + 10}
    gaps = (320 - 250) + (460 - 420) + (700 - 500) + (960 - 710) + (1100 - 980) + 10
    assert sum(charged.values()) == gaps


def test_each_reader_on_the_synthetic_step():
    ctx = {"trace": _trace()}
    ns = 1e-6
    want = {"optim_host_ms.train": 300 * ns, "backward_host_ms.train": 300 * ns,
            "optim_idle_ms.train": 290 * ns, "backward_idle_ms.train": 160 * ns,
            "optim_launches.train": 1.0}
    for name, value in want.items():
        assert reader(name)(ctx) == pytest.approx(value), name
    assert spans.device_ms_in(ctx, "backward") == pytest.approx(140 * ns)
    assert spans.device_ms_in(ctx, "forward") == pytest.approx(200 * ns)
    assert spans.launches_in(ctx, "forward") == 1.0


def test_forecast_readers():
    sp = [Span("rollout", 1, None, 1, MAIN, 0, 100)]
    sp += [Span("forecast_step", 2 + 4 * i, 1, 1, MAIN, 10 + 40 * i, 40 + 40 * i)
           for i in range(2)]
    sp += [Span(n, 3 + 4 * i + j, 2 + 4 * i, 1, MAIN, 12 + 40 * i + 10 * j,
                20 + 40 * i + 10 * j) for i in range(2) for j, n in
           enumerate(("advection", "diffusion"))]
    kernels = [(f"k{i}", 100 + 50 * i, 130 + 50 * i, i, t)
               for i, t in enumerate((15, 25, 55, 65))]
    tr = spans.SpanTrace(events=[k[:3] for k in kernels], steps=2, spans=sp,
                         launches={c: ("cudaLaunchKernel", t, t + 1, 1)
                                   for _, _, _, c, t in kernels},
                         correlations=[k[3] for k in kernels])
    ctx = {"trace": tr}
    assert reader("dispatch_ms.forecast")(ctx) == pytest.approx(30e-6)
    assert reader("advection_ms.forecast")(ctx) == pytest.approx(30e-6)
    assert reader("diffusion_ms.forecast")(ctx) == pytest.approx(30e-6)


def test_readers_return_none_without_spans():
    from port_bench.trace import Trace

    bare = Trace(events=[("k", 0, 10)], steps=3, window_s=1.0, busy_s=1e-8)
    for m in spans.METRICS:
        assert reader(m["name"])({"trace": bare}) is None, m["name"]
        assert reader(m["name"])({"trace": spans.SpanTrace(steps=3)}) is None, m["name"]


def test_clock_checks():
    checks = spans.clock_checks(_trace())
    assert checks["events"] == 7 and checks["matched_share"] == pytest.approx(6 / 7)
    assert checks["in_span_share"] == pytest.approx(5 / 6)
    assert checks["before_launch"] == [] and checks["least_lag_ns"] == 10
    assert checks["charged_ms"] == pytest.approx(690e-6)
    assert checks["gaps_ms"] == pytest.approx(690e-6)
    assert checks["lead_ms"] == pytest.approx(70e-6) and checks["tail_ms"] == pytest.approx(5e-6)
    assert checks["named_share"] == pytest.approx(1 - 110 / 690)
    assert checks["idle_ms_a_step_by_span"]["normuon"] == pytest.approx(190e-6)
    assert checks["launch_call_ms_a_step_under"]["optimizer"] == pytest.approx(10e-6)
    dev = checks["device_ms_a_step_under"]
    assert dev["backward"] == pytest.approx(140e-6) and dev["interpolation_bwd"] == 40e-6
    assert dev["train_step"] == pytest.approx(200e-6 + 140e-6 + 10e-6 + 20e-6)
    assert dev[spans.OUTSIDE] == pytest.approx(110e-6)
    own = checks["host_self_ms_a_step_by_span"]
    assert own["optimizer"] == pytest.approx((300 - 40 - 190) * 1e-6)
    assert own["train_step"] == pytest.approx((1000 - 190 - 300 - 300) * 1e-6)


def test_the_metrics_would_fit_the_benchmark():
    """Each entry of ``METRICS`` in ``BENCHMARK.json``'s form: a name, a unit,
    a layer the file already names, an end-to-end metric that each of its
    cells reports, and a reader file."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = {m["layer"] for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    names = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]}
    for m in spans.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
        assert m["name"] not in names and m["layer"] in layers and m["better"] == "lower"
        assert set(m["workloads"]) <= cells
        e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e["workloads"])
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
