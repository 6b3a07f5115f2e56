"""How many torch threads a test process uses.

torch opens an intra-op thread pool as large as the machine in every
process.  Under pytest-xdist each worker opens one, so ``workers x
cores`` threads contend for the cores, and cases made of many small
tensor ops run tens to hundreds of times slower than alone.  Each test
process therefore takes its share of the cores it may run on: all of
them without xdist, one each when the workers are as many as the cores.
"""

import os


def pytest_configure(config):
    try:
        import torch
    except ImportError:     # the JAX package's tests need no torch
        return
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, cores // workers))
