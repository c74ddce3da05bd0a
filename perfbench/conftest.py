"""pytest settings of the benchmark's own tests (``pytest perfbench``): the
harness, the reference and the program on the import path, one thread a
test process, and the ``card`` marker for tests that need a CUDA device
(each decides inside the test, and skips without one)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
