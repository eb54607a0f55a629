"""Kernels a train step launched inside `optimizer` (copies and fills left
out), from the traced window; a count, which the profiler does not move."""
from port_bench.spans import launches_in


def read(ctx):
    return launches_in(ctx, "optimizer")
