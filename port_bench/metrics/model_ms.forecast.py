"""Device ms a forecast step inside the model's forward."""
from port_bench.metrics.common import range_ms


def read(ctx):
    return range_ms(ctx, "model")
