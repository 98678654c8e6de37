"""The benchmark's CPU tests run tiny models while other test processes
share the cores: one intra-op thread each, since torch's default of one a
core, oversubscribed, makes the training cell's small products spin for
tens of seconds."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
