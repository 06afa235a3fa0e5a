"""One intra-op thread for the port's CPU tests.

A test file of the port imports the fixture, and pytest applies it to
every test of that file:

    from torch_threads import one_thread  # noqa: F401

The tier-1 run puts six workers on the machine's cores, and a worker's
BLAS threads then contend with the other workers' (measured on an
8-core machine: a 1500-row approx fit took 69 s at torch's default of 8
threads beside seven busy cores and 1.2 s at 1; a ``train_nusvr`` fit
took 35.3 s at 8 and 9.5 s at 1). Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
