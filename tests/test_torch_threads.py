"""The port's CPU test modules run with torch's intra-op thread pool off.

Each ``tests/test_torch_*.py`` module imports ``one_torch_thread``, an
autouse module fixture. Their tensors are small (nao 7-110), and there
the pool's threads cost more CPU time than they save: the port's whole
CPU suite in one process took 437 s wall and 653 s of CPU with the
default pool, 382 s and 433 s with one thread. The tier-1 command runs
six xdist workers on the host's cores, so that CPU time is taken from
the other workers. This module holds no tests.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
