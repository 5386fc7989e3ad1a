"""torch's CPU threads under pytest-xdist: each worker gets its share of
the cores.

torch sizes its intra-op pool to every core of the machine, in each
process. Under ``-n 6`` six workers then run six such pools on the same
cores, and torch's OpenMP threads spin at every op's barrier while others
hold the cores: a test that takes 9 s alone took 193 s in a full parallel
run. ``share_cores()`` gives each worker ``cores // workers`` threads (at
least one), and the same through ``OMP_NUM_THREADS`` to the processes a
test starts (``core_budget``, which a test's world of W ranks divides
among them). Outside xdist it changes nothing. Every port test module
calls it at import; xdist workers import every module when they collect,
so the first call in a worker sets it for all its tests.
"""

import os

import torch


def core_budget() -> int:
    """The threads this worker's share of the cores gives (all the cores
    outside xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        return
    threads = core_budget()
    os.environ["OMP_NUM_THREADS"] = str(threads)
    if torch.get_num_threads() != threads:
        torch.set_num_threads(threads)
