"""Test settings of the benchmark's own tests.  The ``gpu`` marker, as the
repository's ``tests/conftest.py`` registers it: a test that needs a CUDA
card, which decides inside itself whether there is one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
