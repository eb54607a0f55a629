"""The interpolation kernels' bound over their device time."""
from port_bench.metrics.common import interp_roofline as read  # noqa: F401
