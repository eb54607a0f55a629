"""Device ms a train step under the optimizer's step and grad_norm."""
from port_bench.metrics.common import range_ms


def read(ctx):
    return range_ms(ctx, "optimizer")
