"""Device idle ms a train step charged to `backward` and the spans under
it.  Read from the traced window, whose profiler slows the host: more idle
than an untraced step has."""
from port_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "backward")
