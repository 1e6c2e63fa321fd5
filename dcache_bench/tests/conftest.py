"""Settings of the benchmark's own tests (run by the repository's pytest)."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (inside the "
        "`card` fixture, never at collection)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny runs are timed windows: with one torch thread each, the
    test workers running side by side do not starve one another."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
