"""The torch thread count of the port's tests, decided once for the process.

Every tests/test_torch_*.py imports this module, so its first import sets
THREADS torch intra-op threads for the whole process: in a suite run (where
pytest-xdist's workers each collect every module) and in a file run alone.

Why one: the tier-1 suite runs several workers on one machine's cores, and
the port's tests run thousands of small ops. At torch's default of a thread
a core, each op's parallel region waits on cores that the other workers
hold. One thread is also the mesh ranks' count (`threads=1` in
`parallel.mesh.spawn`), so a bitwise comparison of this process's run with a
rank's sees the same count on both sides.
"""

import os

import torch

THREADS = 1
torch.set_num_threads(THREADS)


def subprocess_env(**extra) -> dict:
    """This process's environment for a child process a test starts (a CLI,
    a torchrun rank): OpenMP at THREADS threads, `extra` added."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)
