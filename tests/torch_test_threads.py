"""One intra-op thread for the port's tests.

The test command spreads the test files over several pytest-xdist worker
processes on a machine with few cores.  PyTorch's default intra-op pool
takes one thread per core in every process, so the workers' pools
oversubscribe the cores and a port test runs several times slower than
alone (the TTA exit test's
adaptation test: 15 s with one thread, 90 s with the default pool beside one
other busy process).  Every port test file imports this module; it sets one
thread here and, through ``OMP_NUM_THREADS``, in the subprocesses the tests
start.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
