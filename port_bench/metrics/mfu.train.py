"""The whole step's model FLOPs over the card's peak for the cell's precision."""
from port_bench.metrics.common import mfu as read  # noqa: F401
