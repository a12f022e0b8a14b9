import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see 1 device
# (the 512-device fake topology belongs to launch/dryrun.py ONLY).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # container has no hypothesis; install the deterministic mini-stub so the
    # property tests still collect and run
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback  # noqa: F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where none is visible")
