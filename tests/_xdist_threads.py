"""One thread a pool in each pytest-xdist worker.

The suite runs under pytest-xdist with as many workers as the machine
has cores, or nearly. torch's intra-op pool and numpy's OpenBLAS pool
each start a thread a core in every worker, which oversubscribes the
cores and slows every worker's tests, the JAX package's included. Each
port test file imports this module; a run without xdist keeps the
defaults."""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        pass
    else:
        threadpool_limits(1)
