"""Two torch intra-op threads while a port test module runs.

The suite runs its files side by side, a few processes on a few cores.
torch's default of one intra-op thread a core then oversubscribes them,
and every small op waits on threads that the other processes hold (the
linear-probe plain version's thousands of small steps ran 60 times
slower than alone). A module takes the fixture by importing it:

    from tests.torch_threads import few_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
