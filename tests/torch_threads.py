"""One torch thread cap for the port's test processes.

Every ``tests/test_torch_*.py`` imports this module first.  Under
pytest-xdist each worker is a process with torch's intra-op pool, which
defaults to every core; six workers on eight cores then spin 48 threads and
a test takes many times its solo time.  The cap shares the cores out among
the workers: ``os.cpu_count() // workers``, where ``workers`` is the count
xdist sets in ``PYTEST_XDIST_WORKER_COUNT`` (1 without xdist), and at least
one.  A file run alone keeps every core.

``OMP_NUM_THREADS`` is set to the same number unless it is set already, so
the processes the tests start inherit the cap.  The package under test is
not touched: its threading stays as its users get it.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
