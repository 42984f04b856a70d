"""Advanced core-runtime features: streaming generators, async actors,

The port's mirror of `tests/test_core_advanced.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).
concurrency groups, cancellation, max_calls.

Reference coverage model: python/ray/tests/test_streaming_generator*.py,
test_asyncio.py, test_concurrency_group.py, test_cancel.py.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import TaskCancelledError, TaskError


@pytest.fixture(scope="module")
def cluster():
    try:
        yield ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=8)
    finally:
        ray_tpu_torch.shutdown()


def _overlap(spans):
    """Whether every pair of (start, end) spans overlaps in time: the
    calls ran concurrently. Read from times the actor recorded, so a
    loaded host that delays the calls cannot fail it, unlike a wall-clock
    bound on the caller's side."""
    return all(a0 < b1 and b0 < a1 for i, (a0, a1) in enumerate(spans)
               for b0, b1 in spans[i + 1:])


# ------------------------------------------------------------- generators
def test_streaming_generator_basic(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    refs = list(gen.remote(5))
    assert len(refs) == 5
    assert ray_tpu_torch.get(refs) == [0, 1, 4, 9, 16]


def test_streaming_generator_consumed_while_producing(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        for i in range(4):
            time.sleep(0.05)
            yield i

    out = [ray_tpu_torch.get(r) for r in slow_gen.remote()]
    assert out == [0, 1, 2, 3]


def test_streaming_generator_backpressure(cluster):
    @ray_tpu_torch.remote(num_returns="streaming",
                    _generator_backpressure_num_objects=2)
    def gen():
        for i in range(20):
            yield i

    g = gen.remote()
    time.sleep(0.5)  # producer must be throttled, not done
    out = [ray_tpu_torch.get(r) for r in g]
    assert out == list(range(20))


def test_streaming_generator_error_mid_stream(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    refs = list(gen.remote())
    assert len(refs) == 3
    assert ray_tpu_torch.get(refs[0]) == 1
    assert ray_tpu_torch.get(refs[1]) == 2
    with pytest.raises(TaskError, match="boom"):
        ray_tpu_torch.get(refs[2])


# ------------------------------------------------------------ async actors
def test_async_actor_concurrency(cluster):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def wait(self, t):
            import asyncio

            t0 = time.time()
            await asyncio.sleep(t)
            return os.getpid(), (t0, time.time())

    a = AsyncActor.options(max_concurrency=4).remote()
    out = ray_tpu_torch.get([a.wait.remote(0.3) for _ in range(4)])
    spans = [span for _, span in out]
    assert _overlap(spans), f"async calls did not overlap: {spans}"
    assert len({pid for pid, _ in out}) == 1


def test_async_actor_semaphore_limits(cluster):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def wait(self):
            import asyncio

            await asyncio.sleep(0.2)
            return True

    a = AsyncActor.options(max_concurrency=1).remote()
    t0 = time.perf_counter()
    ray_tpu_torch.get([a.wait.remote() for _ in range(3)])
    dt = time.perf_counter() - t0
    assert dt >= 0.55, f"max_concurrency=1 not enforced: {dt:.2f}s"


def test_concurrency_groups(cluster):
    @ray_tpu_torch.remote
    class Worker:
        @ray_tpu_torch.method(concurrency_group="io")
        def io_wait(self):
            t0 = time.time()
            time.sleep(0.5)
            return "io", (t0, time.time())

        def compute(self):
            time.sleep(0.3)
            return "c"

    w = Worker.options(concurrency_groups={"io": 2}).remote()
    # two io calls run concurrently in their own group even though the
    # default group is serial
    out = ray_tpu_torch.get([w.io_wait.remote(), w.io_wait.remote()])
    assert [tag for tag, _ in out] == ["io", "io"]
    spans = [span for _, span in out]
    assert _overlap(spans), f"io group not concurrent: {spans}"


# ------------------------------------------------------------ cancellation
def test_cancel_running_task(cluster, tmp_path):
    started = tmp_path / "started"

    @ray_tpu_torch.remote
    def spin(sec, marker):
        open(marker, "w").close()
        deadline = time.monotonic() + sec
        while time.monotonic() < deadline:
            time.sleep(0.01)
        return "finished"

    ref = spin.remote(30, str(started))
    deadline = time.monotonic() + 30
    while not started.exists():  # wait until it runs
        assert time.monotonic() < deadline, "task never started"
        time.sleep(0.05)
    status = ray_tpu_torch.cancel(ref)
    assert status in ("interrupt_sent", "cancelled_queued")
    with pytest.raises((TaskCancelledError, TaskError)):
        ray_tpu_torch.get(ref, timeout=10)


def test_cancel_queued_task(cluster):
    @ray_tpu_torch.remote(num_cpus=1000)  # unschedulable: stays queued
    def never():
        return 1

    ref = never.remote()
    assert ray_tpu_torch.cancel(ref) == "cancelled_queued"
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=5)


# --------------------------------------------------------------- max_calls
def test_max_calls_retires_worker(cluster):
    @ray_tpu_torch.remote(max_calls=1)
    def whoami():
        return os.getpid()

    pids = {ray_tpu_torch.get(whoami.remote()) for _ in range(3)}
    assert len(pids) == 3, f"workers were reused despite max_calls=1: {pids}"
