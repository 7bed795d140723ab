"""One torch intra-op thread per pytest-xdist worker.

Imported by the port's CPU tests.  Under xdist every worker would
otherwise size its OpenMP pool to all the host's cores, and the workers'
pools together oversubscribe them: the port's CPU tests then ran more than
ten times slower on an 8-core host (52 s against many minutes for
tests/test_torch_*.py with four workers).  A single-process run keeps
torch's default.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
