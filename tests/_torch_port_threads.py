"""One torch intra-op thread for each of the port's CPU test modules.

The suite runs under ``pytest -n 6 --dist loadfile``: six worker processes,
each of which would otherwise give torch one OpenMP thread per CPU. The plain
twins' many small ops then wait in OpenMP barriers for threads that are
descheduled, and the port's tests take several times longer than on one
thread each.

Every ``tests/test_torch_port_*.py`` imports ``torch_one_thread`` by name, so
pytest applies it to that module; ``tests/test_torch_port_threads.py`` holds
each file to it. The count is restored when the module ends, so the JAX-side
tests that a worker runs next keep torch's default. The count is not set at
import time: xdist imports every module when it collects.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """Run the body on one torch intra-op thread, then restore the count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    with one_thread():
        yield
