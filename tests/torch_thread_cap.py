"""Cap torch's intra-op threads in a pytest-xdist worker.

Under ``pytest -n N`` every worker is a process of its own, and torch
starts as many intra-op threads as the machine has cores in each: N
workers then run N × cores threads on the cores, and a CPU reduction that
takes seconds alone takes minutes. Importing this module gives each
worker ``cores // N`` threads (at least one) when xdist has set
``PYTEST_XDIST_WORKER_COUNT``, and changes nothing in a plain ``pytest``
run. Every ``tests/test_torch_*.py`` imports it; xdist workers import
every test module they collect, so the cap holds for the whole worker.
"""
import os

import torch


def thread_cap() -> int:
    """Intra-op threads for one worker: the cores shared out over the
    workers, at least one; 0 outside xdist (no cap)."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return 0
    return max(1, (os.cpu_count() or 1) // max(1, int(workers)))


if thread_cap():
    torch.set_num_threads(thread_cap())
