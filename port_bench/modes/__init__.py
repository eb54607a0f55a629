"""The ways a cell drives the program, one module each, found by the
traffic's ``mode``: ``train`` and ``forecast``.  A mode module defines
``Mode(run)`` with ``setup()``, ``window(seconds)``, ``traced()``,
``flops()``, ``release()`` and ``check()`` (see ``port_bench/run.py``)."""
