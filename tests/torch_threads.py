"""One torch intra-op thread for the test modules that import
``one_torch_thread``: the tier-1 run's workers share the CPU, and a torch
pool that spans every core in each worker makes them stall one another. A
tiny training step (``tests/test_torch_port_bwd_skip.py::
test_training_cotangent_is_zero_on_padding_slots``) beside five other
processes running it at torch's default 8 threads on an 8-core machine took
410 s at 8 threads, 63 s at 2 and 43 s at 1."""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
