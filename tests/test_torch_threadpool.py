"""``ptype_tpu_torch.threadpool``: work runs on reused threads, never
waits for a free one, survives an exception, and an idle worker exits;
a group waits for its jobs. Each test runs its own ``Pool``, apart from
the process's, which other code in the process also uses. (The module
has no reference twin: the reference starts a thread a call.)"""

import sys
import threading
import time

from ptype_tpu_torch import threadpool


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _ident_of(pool, fn=None):
    """The thread a job ran on (after ``fn``, when given)."""
    seen, done = [], threading.Event()

    def job():
        seen.append(threading.get_ident())
        done.set()
        if fn is not None:
            fn()

    pool.spawn(job)
    assert done.wait(10)
    return seen[0]


def test_work_reuses_an_idle_thread():
    pool = threadpool.Pool()
    seen = []
    for _ in range(5):
        seen.append(_ident_of(pool))
        _wait(lambda: pool.idle() == 1)
    assert len(set(seen)) == 1


def test_concurrency_is_not_bounded():
    """Work that blocks holds its thread: 40 jobs all waiting on one
    barrier finish, so none waited for another's thread."""
    pool = threadpool.Pool()
    n = 40
    barrier = threading.Barrier(n + 1)
    for _ in range(n):
        pool.spawn(barrier.wait, 10)
    barrier.wait(10)
    _wait(lambda: pool.idle() == n)


def test_an_exception_leaves_the_worker_serving(capsys):
    pool = threadpool.Pool()

    def boom():
        raise ValueError("boom")

    first = _ident_of(pool, boom)
    _wait(lambda: pool.idle() == 1)  # parked again after the report
    assert _ident_of(pool) == first
    assert "ValueError: boom" in capsys.readouterr().err


def test_an_idle_worker_exits():
    pool = threadpool.Pool(idle_s=0.05)
    _ident_of(pool)
    _wait(lambda: pool.idle() == 1)
    _wait(lambda: pool.idle() == 0)
    _ident_of(pool)  # a fresh worker takes the next job


def test_concurrent_spawns_run_every_job_once():
    """Eight threads each spawn 200 jobs at once, the interpreter
    switching threads every microsecond: every job runs exactly once (a
    handoff lost or given twice under the lock would break the count)."""
    pool = threadpool.Pool()
    counts = [0] * 1600
    lock = threading.Lock()
    done = threading.Semaphore(0)

    def job(i):
        with lock:
            counts[i] += 1
        done.release()

    def producer(base):
        for i in range(base, base + 200):
            pool.spawn(job, i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=producer, args=(200 * k,))
                     for k in range(8)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(30)
            assert not t.is_alive()
        for _ in range(len(counts)):
            assert done.acquire(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert counts == [1] * len(counts)


def test_a_group_waits_for_its_jobs():
    group = threadpool.Group(threadpool.Pool())
    release = threading.Event()
    seen = []
    for i in range(5):
        group.spawn(lambda i: (release.wait(10), seen.append(i)), i)
    assert not group.wait(0.05)  # all five still blocked
    release.set()
    assert group.wait(10)
    assert sorted(seen) == list(range(5))
