"""pytest settings of the test suite."""


def pytest_configure(config):
    # tests that need an NVIDIA card decide inside a fixture and skip
    # without one; on the card: python -m pytest -m cuda tests/
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA); skips without one")
