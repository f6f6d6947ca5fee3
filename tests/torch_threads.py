"""One CPU thread a test process for the port's tests.

The suite runs in several pytest-xdist workers on one machine, and each
worker's thread pools -- torch's intra-op pool, OpenBLAS's (numpy, scipy)
and OpenMP's -- start at one thread a core. The workers' threads then
contend for the same cores: an OpenBLAS dot split over eight threads waits
on threads the other workers keep busy, and a call of a fraction of a
second takes minutes. At one thread a worker each process keeps its own
core.

Every ``tests/test_torch_*.py`` imports :func:`one_cpu_thread`, a
module-scoped ``autouse`` fixture: for the module's tests it sets torch's
threads, OpenBLAS's and OpenMP's (``threadpoolctl``) to one, and the
environment's ``OMP_NUM_THREADS``, ``OPENBLAS_NUM_THREADS`` and
``MKL_NUM_THREADS`` to 1 for the processes the tests start (gloo ranks, the
command-line mains); after them it restores all three, so the next module
on the same worker runs as it would alone. It acts only while a module's
tests run, never at import: every worker imports every test module when
it collects. ``threadpoolctl`` comes with scikit-learn, which a machine
with a card may lack; there torch's own limit and the environment's hold.

    from .torch_threads import one_cpu_thread  # noqa: F401
"""

import contextlib
import os

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:
    def threadpool_limits(limits):
        return contextlib.nullcontext()

ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    env = {k: os.environ.get(k) for k in ENV}
    torch.set_num_threads(1)
    os.environ.update(dict.fromkeys(ENV, "1"))
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
