"""The benchmark's tests find the repository's root and the port on the
path.  Run them from the root: ``PYTHONPATH=src python -m pytest -q
bench/tests``."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spec  # noqa: E402


@pytest.fixture(scope="session")
def bench_json():
    return spec.benchmark()
