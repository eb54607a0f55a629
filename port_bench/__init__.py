"""The benchmark of ``paradis_torch`` on an NVIDIA H100 (see ``run.py``)."""
