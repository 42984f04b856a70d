"""Core runtime: tasks, objects, actors, fault tolerance.

The port's mirror of `tests/test_core_runtime.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Mirrors the reference's test strategy (SURVEY.md §4): a real multi-process
cluster on one machine, fake resources, induced worker kills.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.api import get_actor
from ray_tpu_torch.core.exceptions import ActorDiedError, GetTimeoutError, TaskError


@pytest.fixture(scope="module")
def cluster():
    try:
        yield ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=8)
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.v = start

    def incr(self, k=1):
        self.v += k
        return self.v

    def value(self):
        return self.v

    def pid(self):
        return os.getpid()


def test_task_roundtrip(cluster):
    assert ray_tpu_torch.get(add.remote(1, 2)) == 3


def test_task_chained_deps(cluster):
    r = add.remote(1, 2)
    assert ray_tpu_torch.get(add.remote(r, 10)) == 13


def test_large_object_shm(cluster):
    x = np.arange(500_000, dtype=np.float64)
    ref = ray_tpu_torch.put(x)

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    assert ray_tpu_torch.get(total.remote(ref)) == pytest.approx(float(x.sum()))


def test_task_error_propagates(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("bang")

    with pytest.raises(TaskError, match="bang"):
        ray_tpu_torch.get(boom.remote())
    # errors flow through dependent tasks too
    with pytest.raises(TaskError, match="bang"):
        ray_tpu_torch.get(add.remote(boom.remote(), 1))


def test_get_timeout(cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.3)


def test_wait(cluster):
    refs = [add.remote(i, i) for i in range(6)]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=3, timeout=15)
    assert len(ready) == 3 and len(not_ready) == 3
    ready2, _ = ray_tpu_torch.wait(refs, num_returns=6, timeout=15)
    assert len(ready2) == 6


def test_actor_basic(cluster):
    c = Counter.remote(10)
    for _ in range(3):
        c.incr.remote()
    assert ray_tpu_torch.get(c.value.remote()) == 13


def test_actor_method_error(cluster):
    @ray_tpu_torch.remote
    class Bad:
        def boom(self):
            raise RuntimeError("actor bang")

    b = Bad.remote()
    with pytest.raises(TaskError, match="actor bang"):
        ray_tpu_torch.get(b.boom.remote())


def test_named_actor(cluster):
    Counter.options(name="named-counter").remote(100)
    h = get_actor("named-counter")
    assert ray_tpu_torch.get(h.value.remote()) == 100
    with pytest.raises(ValueError):
        get_actor("does-not-exist")


def test_actor_constructor_failure(cluster):
    @ray_tpu_torch.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("ctor fail")

        def ping(self):
            return 1

    b = Broken.remote()
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(b.ping.remote())


def test_kill_actor(cluster):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote()) == 1
    ray_tpu_torch.kill(c)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(c.incr.remote())


def test_actor_restart_on_worker_death(cluster):
    c = Counter.options(max_restarts=2).remote(5)
    pid = ray_tpu_torch.get(c.pid.remote())
    os.kill(pid, 9)
    # the restart re-runs the constructor (state resets to 5, like the
    # reference's restart semantics without checkpointing)
    deadline = time.monotonic() + 30
    while True:
        try:
            v = ray_tpu_torch.get(c.value.remote())
            break
        except ActorDiedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    assert v == 5
    assert ray_tpu_torch.get(c.pid.remote()) != pid


def test_task_retry_on_worker_death(cluster, tmp_path):
    marker = str(tmp_path / "attempted")

    @ray_tpu_torch.remote
    def die_once():
        if not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), 9)
        return "survived"

    assert ray_tpu_torch.get(die_once.remote(), timeout=60) == "survived"


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def outer(n):
        refs = [add.remote(i, 1) for i in range(n)]
        return sum(ray_tpu_torch.get(refs))

    assert ray_tpu_torch.get(outer.remote(4), timeout=60) == 10


def test_cluster_resources(cluster):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0
