"""Host ms a forecast step inside the program's `forecast_step` span.  Read
from the traced window, so the profiler's host cost is in it."""
from port_bench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "forecast_step")
