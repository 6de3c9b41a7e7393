"""A fixed, small intra-op thread count for the port's CPU tests.

The tests run in several pytest workers at once. Left alone, torch gives
each worker an intra-op pool as wide as the machine, and the pools then
fight each other, and the JAX package's tests, for the cores: under that
load a pool's threads wait on each other, and a test runs many times
slower than on one thread. With one thread, a CPU product also sums in
one order on every run, so the tests' bit-for-bit comparisons of two runs
hold by construction.

Every ``tests/test_torch_*.py`` module that runs torch on the CPU imports
:func:`torch_threads` by name. It pins the count for the module (and, via
``OMP_NUM_THREADS``, for the processes the module starts) and restores
both when the module ends, so that another module on the same worker runs
as before.
"""

import contextlib
import os

import pytest
import torch

TORCH_THREADS = 1


@contextlib.contextmanager
def pinned_threads(n: int):
    """``torch.set_num_threads(n)`` and ``OMP_NUM_THREADS=n`` inside the
    block, the previous count and variable after it."""
    before = torch.get_num_threads()
    env_before = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
        if env_before is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_before


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    with pinned_threads(TORCH_THREADS):
        yield


def test_module_runs_on_the_pinned_count():
    assert torch.get_num_threads() == TORCH_THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(TORCH_THREADS)


@pytest.mark.parametrize("exit_by", ["return", "raise"])
def test_pinned_threads_restores_the_previous_count(exit_by):
    outer = TORCH_THREADS + 1
    torch.set_num_threads(outer)
    try:
        with contextlib.suppress(RuntimeError):
            with pinned_threads(TORCH_THREADS):
                assert torch.get_num_threads() == TORCH_THREADS
                if exit_by == "raise":
                    raise RuntimeError("leaves the block")
        assert torch.get_num_threads() == outer
        assert os.environ["OMP_NUM_THREADS"] == str(TORCH_THREADS)
    finally:
        torch.set_num_threads(TORCH_THREADS)
