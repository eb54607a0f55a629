"""Kernel launches a step, from the trace."""
from port_bench.metrics.common import launches as read  # noqa: F401
