"""Torch's intra-op threads in the test processes: ``TORCH_THREADS`` each.

The tier-1 command runs six test processes (xdist) on one host. With torch's
default of one intra-op thread per core in each, the processes oversubscribe
the cores and every torch test waits on the others' threads: the port's tests
(tests/test_torch_*.py) summed 4,293 test-seconds with the default and 990 with
two threads a process, on an 8-core host, by the tier-1 command's own flags
over those files. Every module of the port's tests that runs torch on the CPU
imports ``torch_threads``, an autouse module fixture that sets the count, and
``OMP_NUM_THREADS`` for the processes its tests start, while the module runs,
and puts both back afterwards. The card's kernel tests
(tests/test_torch_kernels_cuda.py) run without this conftest's JAX and do
not import it."""

import os
import subprocess
import sys

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(TORCH_THREADS)
    os.environ["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_the_module_and_its_processes_run_on_two_threads():
    assert torch.get_num_threads() == TORCH_THREADS
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert int(out) == TORCH_THREADS
