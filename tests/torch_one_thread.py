"""One intra-op thread for the port's CPU tests.

The port's tests hold small tensors (a few thousand rows), where
PyTorch's intra-op thread pool costs more than it gives: the 50 TPC-DS
queries run about eight times faster on one thread than on eight, and
the test workers that run side by side (``pytest -n``) would each start
a pool as wide as the machine.  Every ``tests/test_torch_*.py`` imports
this module first.  The results are the same, as each comparison's
tolerance is stated for any order of float sums.
"""

import torch

torch.set_num_threads(1)
