"""Set-up shared by every test module here.

Under pytest-xdist each worker gets its share of the CPU's threads: six
workers, each with a full OpenMP pool of every core, oversubscribe the cores
and queue the suite for them.  Outside xdist the thread count is left alone.
Each phase of a test (setup, body, teardown) also has a time limit, so a hang
fails that one test by name instead of using up the whole run's clock.
"""

import contextlib
import os
import signal
import threading
import time

import pytest

TEST_TIME_LIMIT_S = 300   # ~7x the slowest phase seen, at one thread a worker


def share_cpu():
    """Cap this xdist worker's OpenMP/MKL pools at its share of the CPUs it
    may run on, unless the caller set them.  The variables reach numpy's
    BLAS and the tests' subprocesses; torch is told directly too, in case a
    plugin imported it already."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or "OMP_NUM_THREADS" in os.environ:
        return
    ncpu = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count())
    threads = max(1, ncpu // int(workers))
    os.environ["OMP_NUM_THREADS"] = str(threads)
    os.environ.setdefault("MKL_NUM_THREADS", str(threads))
    import torch
    torch.set_num_threads(threads)


share_cpu()


@contextlib.contextmanager
def time_limit(seconds, name):
    """Fail ``name`` if the block runs past ``seconds``.  Uses SIGALRM, so it
    acts only in the main thread on POSIX; an outer limit is restored."""
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{name} ran past its {seconds} s time limit",
                    pytrace=False)

    start = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, expire)
    outer_left = signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_handler)
        if outer_left:
            signal.alarm(max(1, round(outer_left - (time.monotonic() - start))))


@pytest.hookimpl(hookwrapper=True)
def _limited(item):
    with time_limit(TEST_TIME_LIMIT_S, item.nodeid):
        yield


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _limited
