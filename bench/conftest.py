import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.join(HERE, "..", "src"), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels have no CPU "
                   "mode); the test skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    """The harness's runs time a window on the CPU: two intra-op threads a
    test keep parallel test workers from starving each other."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)
