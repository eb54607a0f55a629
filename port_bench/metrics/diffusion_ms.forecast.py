"""Device ms a forecast step of the events launched inside `diffusion`,
from the traced window (the profiler slows the host, not the device)."""
from port_bench.spans import device_ms_in


def read(ctx):
    return device_ms_in(ctx, "diffusion")
