"""The arithmetic the metric readers share."""

from __future__ import annotations

from port_bench import yardstick
from port_bench.trace import in_range, is_kernel


def idle_share(ctx) -> float | None:
    """Per cent of an untraced step in which no device operation runs: one
    less the traced device busy time a step times the untraced window's
    steps a second.  The traced window's own length would count the
    profiler's cost on the host as idle."""
    tr = ctx["trace"]
    if not tr.events or tr.steps <= 0 or not ctx.get("steps_per_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.steps * ctx["steps_per_s"])


def mfu(ctx) -> float | None:
    """Per cent of the card's published peak for the cell's precision that
    the model's FLOPs a step, at the untraced window's rate, make."""
    if not ctx.get("flops") or not ctx.get("member_steps_per_s"):
        return None
    return 100.0 * ctx["flops"] * ctx["member_steps_per_s"] / yardstick.PEAK_FLOPS[ctx["precision"]]


def _ms(events) -> float:
    return sum(e - s for _, s, e in events) / 1e6


def interp_roofline(ctx) -> float | None:
    """Per cent: the interpolation calls' summed bound over the device time
    of the kernels inside their ranges."""
    tr = ctx["trace"]
    spent = _ms(in_range(tr.events, tr.ranges, "interpolation"))
    if not tr.interp_calls or spent <= 0:
        return None
    bound_ms = sum(yardstick.call_bound_s(c) for c in tr.interp_calls) * 1e3
    return 100.0 * bound_ms / spent


def range_ms(ctx, label: str) -> float | None:
    tr = ctx["trace"]
    inside = in_range(tr.events, tr.ranges, label)
    if not inside or tr.steps <= 0:
        return None
    return _ms(inside) / tr.steps


def model_ms_train(ctx) -> float | None:
    """Device ms a step of everything but the loss and the optimizer: the
    model's forward, its backward (with the replay, where the configuration
    checkpoints), and the step's few scalar operations."""
    tr = ctx["trace"]
    if not tr.events or tr.steps <= 0 or not tr.ranges:
        return None
    other = _ms(in_range(tr.events, tr.ranges, "loss")) + _ms(
        in_range(tr.events, tr.ranges, "optimizer"))
    return (_ms(tr.events) - other) / tr.steps


def launches(ctx) -> float | None:
    """Kernels a step (copies and fills left out)."""
    tr = ctx["trace"]
    n = sum(is_kernel(name) for name, _, _ in tr.events)
    if not n or tr.steps <= 0:
        return None
    return n / tr.steps
