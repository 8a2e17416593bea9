"""Bounds torch's CPU thread pool in the port's test processes (imported
by every ``tests/test_torch_*.py`` before anything of torch runs; not a
test file itself).

torch's intra-op pool is OpenMP with one worker per core, and its workers
spin between parallel regions.  Beside other busy pytest-xdist workers each
region's barrier waits until every spinning worker is scheduled again, so
the port's CPU tests ran 30x and more slower under load than alone.  One
thread is enough at the tests' sizes, and the results do not depend on it:
the tests hold the port to the JAX package bit for bit either way.
"""

import torch

torch.set_num_threads(1)
