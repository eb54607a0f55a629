"""Host ms a train step inside the program's `backward` span.  Read from
the traced window, so the profiler's host cost is in it."""
from port_bench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "backward")
