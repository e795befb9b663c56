"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the marker of the tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
