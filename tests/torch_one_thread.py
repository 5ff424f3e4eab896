"""torch on one thread for a whole test module.

Beside the other test workers, torch's default threads oversubscribe the
cores: the heavy port files ran 2-7x slower on them than on one thread each
(ROADMAP "Tier-1 time"). Import the fixture into a test module to apply it
there, module-scoped fixtures included:

    from torch_one_thread import torch_one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
