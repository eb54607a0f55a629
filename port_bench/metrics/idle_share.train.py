"""Per cent of an untraced step with no device operation running."""
from port_bench.metrics.common import idle_share as read  # noqa: F401
