"""Every port test module runs torch on one intra-op thread.

``tests/_torch_port_threads.py`` holds the module-scoped fixture that pins
the count and restores it after the module. Each ``test_torch_port_*.py``
imports it by name; this file checks that each one does, that the count is 1
inside a port module, and that the count comes back afterwards.
"""

import ast
import pathlib

import torch

from _torch_port_threads import one_thread
from _torch_port_threads import torch_one_thread  # noqa: F401

TESTS = pathlib.Path(__file__).resolve().parent


def _imports_fixture(path):
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.ImportFrom)
                and node.module == "_torch_port_threads"
                and any(a.name == "torch_one_thread" and a.asname is None
                        for a in node.names)):
            return True
    return False


def test_every_port_test_module_imports_the_fixture():
    files = sorted(TESTS.glob("test_torch_port_*.py"))
    assert len(files) > 40
    missing = [f.name for f in files if not _imports_fixture(f)]
    assert missing == [], (
        "import the one-thread fixture at the top level: "
        "from _torch_port_threads import torch_one_thread  # noqa: F401")


def test_a_port_module_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1


def test_the_thread_count_is_restored_after_the_body():
    torch.set_num_threads(2)
    try:
        with one_thread():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(1)
