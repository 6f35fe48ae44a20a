"""One intra-op thread for torch while a file of port tests runs.

The test workers share the host's cores. With torch's default pool (one
thread a core) in every worker, the pools spin against one another's and
the port's sessions ran ten times slower or more than alone (a masked CNN
session's parity test: 321 s beside two other files, 23 s with one thread
each). Port test files take ``one_torch_thread`` by importing it; it sets
one thread for the module and gives the old count back after it. Results
do not depend on it beyond the summation order the tolerances cover; the
port's bit-for-bit comparisons are between two of its own paths, both run
under the same setting.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_while_the_module_runs():
    assert torch.get_num_threads() == 1
