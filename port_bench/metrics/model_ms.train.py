"""Device ms a train step of the model: forward, backward and replay."""
from port_bench.metrics.common import model_ms_train as read  # noqa: F401
