"""Fixtures shared by the port's test files."""
import pytest


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library made unreachable: a wrapper that reached it would
    raise, so a call that returns took its plain version and launched
    nothing."""
    from repro_torch.kernels import _build

    def unreachable(*a, **k):
        raise AssertionError("a call on the CPU reached the kernel library")

    monkeypatch.setattr(_build, "load_library", unreachable)
