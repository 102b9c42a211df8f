"""pytest settings of the benchmark's own tests: the ``card`` marker for
tests that need a CUDA card (each decides inside itself whether there is
one, and skips without)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
