"""The program's spans (``paradis_torch.utils.tracing``): off by default and
free; nesting, parents, roots and threads; self time; the spans of a tiny
train step and of a tiny rollout; and, on a card, launches that lie inside
the spans that issue them (``tests/test_torch_export.py`` holds an exported
graph that does not see them).

No JAX here: the ``gpu`` test runs on the card with ``--noconftest``."""

from __future__ import annotations

import threading

import pytest
import torch

from paradis_torch.tools import profile_step
from paradis_torch.tools.flagship import TINY, TINY_GRID, flagship
from paradis_torch.utils import tracing
from paradis_torch.utils.tracing import Span, recording, self_ns, span

CLOCK_ERROR_NS = 1_000_000
LAYER = ["layer", "velocity_net", "advection", "advection_proj", "departure",
         "interpolation", "advection_proj", "diffusion", "reaction"]


def _tiny_cfg(*overrides):
    from paradis_torch.config import load_config

    return load_config(overrides=[*TINY, *overrides])


def test_off_records_nothing_reads_no_clock_and_returns_one_object(monkeypatch):
    assert not tracing.is_recording()

    def no_clock():
        raise AssertionError("read the clock while off")

    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    first, second = span("train_step"), span("optimizer")
    assert first is second is tracing._OFF
    with first as got:
        assert got is None


def test_nesting_parents_roots_and_threads():
    main = threading.get_native_id()
    with recording() as spans:
        with span("train_step") as root:
            with span("forward") as fwd:
                with span("model") as model:
                    pass

            def other():
                with span("interpolation_bwd"), span("inner"):
                    pass

            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        with span("train_step") as second:
            pass
        assert tracing.is_recording()
        with pytest.raises(RuntimeError, match="already"):
            with recording():
                pass
    assert not tracing.is_recording()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["train_step", "forward", "model", "interpolation_bwd",
                                       "inner", "train_step"]
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)
    assert (model.parent, fwd.parent, root.parent) == (fwd.id, root.id, None)
    assert all(s.root == root.id for s in spans[:5])
    assert all(s.end_ns >= s.start_ns for s in spans)
    bwd = by["interpolation_bwd"]
    assert bwd.parent == root.id and bwd.thread != main and by["inner"].parent == bwd.id
    assert {s.thread for s in (root, fwd, model, second)} == {main}
    assert second.parent is None and second.root == second.id != root.id


def test_self_time_is_the_span_less_its_children():
    spans = [Span("train_step", 1, None, 1, 7, 0, 100),
             Span("forward", 2, 1, 1, 7, 10, 30),
             Span("interpolation_bwd", 3, 1, 1, 8, 20, 50),   # overlaps forward
             Span("optimizer", 4, 1, 1, 7, 90, 120),          # runs past its parent
             Span("grad_norm", 5, 4, 1, 7, 95, 100)]
    assert self_ns(spans) == {1: 100 - 40 - 10, 2: 20, 3: 30, 4: 25, 5: 5}


def test_a_tiny_train_step_records_its_spans_in_order():
    run = profile_step.build_step(1, TINY_GRID, "cpu", tiny=True)
    run["step"]()
    with recording() as spans:
        run["step"]()
    names = [s.name for s in spans]
    layers = run["model"].layers
    steps = run["batch"]["target"].shape[1]
    forward = (["forward", "model", "input_proj", "static_encoder", "downsample"]
               + LAYER * len(layers) + ["output_proj", "loss"])
    # the CPU engine runs the backward on the calling thread
    assert names == (["train_step", "zero_grad"] + forward * steps + ["backward"]
                     + ["interpolation_bwd"] * len(layers)
                     + ["optimizer", "grad_norm", "adamw", "normuon"])
    root = spans[0]
    assert root.parent is None and all(s.root == root.id for s in spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "interpolation_bwd":
            assert by_id[s.parent].name == "backward"
    own = self_ns(spans)
    assert all(v >= 0 for v in own.values()) and own[root.id] < root.end_ns - root.start_ns


def test_a_tiny_rollout_records_one_forecast_step_a_step():
    from paradis_torch.forecast import make_forecast_rollout
    from paradis_torch.tools.flagship import inputs

    cfg = _tiny_cfg("model.num_layers=1")
    model, d = flagship(cfg, TINY_GRID, "cpu")
    batch = inputs(d, TINY_GRID, 3, "cpu")
    rollout = make_forecast_rollout(model, cfg)
    with recording() as spans:
        rollout(batch, d["n_common"])
    names = [s.name for s in spans]
    assert names[0] == "rollout" and names.count("forecast_step") == 3
    assert names.count("model") == 3 and names.count("layer") == 3
    steps = [s for s in spans if s.name == "forecast_step"]
    assert all(s.parent == spans[0].id for s in steps)


@pytest.mark.gpu
def test_launches_lie_inside_the_spans_that_issue_them():
    """A tiny train step on the card under the device-only profiler: every
    kernel has its runtime launch, the kernels start in launch order, and
    each launch lies inside a span; the interpolation's backward runs on
    autograd's thread, under the step's root."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = profile_step.build_step(1, TINY_GRID, "cuda", tiny=True)
    run["step"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as spans:
        run["step"]()
        torch.cuda.synchronize()
    kernels, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append((e.start_ns(), e.correlation_id(), e.name()))
        elif e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns(), e.name(), e.duration_ns()
    assert kernels and all(c in launches for _, c, _ in kernels)
    launches = {c: v[0] for c, v in launches.items()}
    # one stream: the kernels start in the order of their launches; each
    # after its launch, up to the error of the profiler's conversion of the
    # device's clock to the host's (0 to 0.37 ms seen on the card)
    starts = [s for s, _, _ in sorted(kernels, key=lambda k: launches[k[1]])]
    assert starts == sorted(starts)
    assert min(s - launches[c] for s, c, _ in kernels) > -CLOCK_ERROR_NS
    for _, c, _ in kernels:
        t = launches[c]
        assert any(s.start_ns <= t <= s.end_ns for s in spans), t
    root = spans[0]
    assert root.name == "train_step"
    bwd = [s for s in spans if s.name == "interpolation_bwd"]
    assert len(bwd) == len(run["model"].layers)
    assert all(s.thread != root.thread and s.parent == root.id for s in bwd)
    optimizer = next(s for s in spans if s.name == "optimizer")
    inside = [c for _, c, _ in kernels if optimizer.start_ns <= launches[c] <= optimizer.end_ns]
    assert inside
