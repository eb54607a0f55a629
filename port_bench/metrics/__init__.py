"""Per-layer metric readers, one file each, found by the metric's name
(``<name>.py``, loaded by path).  Each defines ``read(ctx)``, which returns
the metric's value from the traced window, or None where it finds nothing
to read.  ``ctx``: ``trace`` (``port_bench.trace.Trace``),
``member_steps_per_s`` (the untraced window's rate of one batch
member's steps), ``steps_per_s`` (its rate of whole batch steps),
``flops`` (model FLOPs of one member's step) and ``precision``."""
