"""Registers the ``cuda`` marker: tests that need an NVIDIA GPU and nvcc.

Each such test decides inside itself (through a fixture) whether a card is
present and skips with a reason when it is not; run them on a GPU machine
with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips where there is none)"
    )
