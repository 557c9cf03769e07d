"""The port's CPU test modules' shared fixture. A module takes it with

    from tests.torch_threads import one_torch_thread  # noqa: F401

and pytest then runs the module's tests on one torch intra-op thread."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests: beside the suite's other
    workers (and a module's own child processes), OpenMP threads spinning
    for a core cost more than they give; the port's CPU files ran several
    times slower in the parallel suite than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
