import os
import sys

# Tests run single-device (the dry-run sets its own 512-device XLA_FLAGS in a
# separate process; multi-device numerics tests spawn subprocesses).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason on a host without one")
