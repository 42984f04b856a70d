"""Compat-shim tests: ActorPool, Queue, multiprocessing.Pool, joblib, tqdm.

Mirrors the reference's test strategy for `ray.util.*` drop-ins
(`python/ray/tests/test_actor_pool.py`, `test_queue.py`,
`python/ray/util/multiprocessing` tests).

The port's mirror of `tests/test_util_compat.py`, against
`ray_tpu_torch`, with parity cases: `ray_dask_get` on the same seeded
graph gives the same values in both packages, and the usage-stats
payload (the head's heartbeat file here) and `timeline()`'s Chrome trace
have the same keys in both. The cluster must leave no process and no
`rtpt_*` segment of its session behind.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


def _assert_session_clean(session):
    import glob

    from ray_tpu_torch.cluster_utils import _session_pids
    from ray_tpu_torch.core.store import SHM_PREFIX

    deadline = time.monotonic() + 15
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _session_pids(session) == []
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}*{session[:8]}*") == []


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=16)
    yield info
    ray_tpu_torch.shutdown()
    _assert_session_clean(info["session"])


@ray_tpu_torch.remote
class _Doubler:
    def double(self, v):
        return 2 * v

    def slow_double(self, v):
        time.sleep(0.05 * (v % 3))
        return 2 * v


def _drain(actors):
    for a in actors:
        ray_tpu_torch.kill(a)


def test_actor_pool_map(cluster):
    actors = [_Doubler.remote() for _ in range(3)]
    pool = ActorPool(actors)
    assert list(pool.map(lambda a, v: a.double.remote(v), range(10))) == [
        2 * i for i in range(10)]
    _drain(actors)


def test_actor_pool_map_unordered(cluster):
    actors = [_Doubler.remote() for _ in range(3)]
    pool = ActorPool(actors)
    out = list(pool.map_unordered(
        lambda a, v: a.slow_double.remote(v), range(9)))
    assert sorted(out) == [2 * i for i in range(9)]
    _drain(actors)


def test_actor_pool_submit_get_next(cluster):
    actors = [_Doubler.remote() for _ in range(2)]
    pool = ActorPool(actors)
    pool.submit(lambda a, v: a.double.remote(v), 1)
    pool.submit(lambda a, v: a.double.remote(v), 2)
    # more submits than actors buffers
    pool.submit(lambda a, v: a.double.remote(v), 3)
    assert pool.has_next()
    assert [pool.get_next(), pool.get_next(), pool.get_next()] == [2, 4, 6]
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()
    _drain(actors)


def test_actor_pool_push_pop(cluster):
    a, b = _Doubler.remote(), _Doubler.remote()
    pool = ActorPool([a])
    with pytest.raises(ValueError):
        pool.push(a)
    pool.push(b)
    assert pool.pop_idle() is not None
    _drain([a, b])


def test_queue_basic(cluster):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.qsize() == 2 and q.full() and not q.empty()
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.1)
    q.shutdown()


def test_queue_batch_and_cross_task(cluster):
    q = Queue()
    q.put_nowait_batch([1, 2, 3])

    @ray_tpu_torch.remote
    def consume(q):
        return [q.get() for _ in range(3)]

    assert ray_tpu_torch.get(consume.remote(q)) == [1, 2, 3]
    q.shutdown()


def test_multiprocessing_pool(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as p:
        assert p.map(abs, [-1, -2, -3, 4]) == [1, 2, 3, 4]
        assert p.apply(max, (3, 5)) == 5
        r = p.apply_async(min, (3, 5))
        assert r.get(timeout=10) == 3
        assert p.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
        assert sorted(p.imap_unordered(abs, [-5, 6])) == [5, 6]
        assert list(p.imap(abs, [-5, 6])) == [5, 6]


def test_multiprocessing_pool_callbacks(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    hits = []
    with Pool(processes=1) as p:
        r = p.apply_async(abs, (-7,), callback=hits.append)
        assert r.get() == 7
        for _ in range(100):
            if hits:
                break
            time.sleep(0.05)
        assert hits == [7]


def test_joblib_backend(cluster):
    from joblib import Parallel, delayed, parallel_backend

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with parallel_backend("ray_tpu_torch", n_jobs=2):
        out = Parallel()(delayed(abs)(i) for i in [-1, -2, -3])
    assert out == [1, 2, 3]


def test_tqdm_ray(cluster):
    from ray_tpu_torch.experimental import tqdm_ray

    @ray_tpu_torch.remote
    def work(n):
        total = 0
        for i in tqdm_ray.tqdm(range(n), desc="work"):
            total += i
        return total

    assert ray_tpu_torch.get(work.remote(10)) == 45


def test_pool_join_waits_for_inflight(cluster):
    """stdlib contract: close()+join() blocks until submitted work finishes."""
    import time

    from ray_tpu_torch.util.multiprocessing import Pool

    def slow(x):
        time.sleep(0.5)
        return x * 2

    with Pool(processes=2) as p:
        r = p.map_async(slow, [1, 2])
        p.close()
        t0 = time.time()
        p.join()
        assert time.time() - t0 > 0.2  # actually waited
        assert r.get(timeout=5) == [2, 4]


def test_pool_stdlib_timeout_and_successful(cluster):
    import multiprocessing
    import time

    import pytest as _pytest

    from ray_tpu_torch.util.multiprocessing import Pool

    def slow(x):
        time.sleep(2)
        return x

    p = Pool(processes=1)
    r = p.apply_async(slow, (1,))
    with _pytest.raises(multiprocessing.TimeoutError):
        r.get(timeout=0.1)
    with _pytest.raises(ValueError):
        r.successful()  # not ready yet → ValueError, never blocks
    assert r.get(timeout=10) == 1
    assert r.successful() is True
    p.terminate()


def test_pool_maxtasksperchild(cluster):
    import os

    from ray_tpu_torch.util.multiprocessing import Pool

    p = Pool(processes=1, maxtasksperchild=2)
    pids = [p.apply(os.getpid) for _ in range(5)]
    # worker replaced after every 2 tasks → more than one distinct pid
    assert len(set(pids)) >= 2, pids
    p.terminate()


def test_queue_graceful_shutdown(cluster):
    from ray_tpu_torch.util.queue import Queue

    q = Queue()
    q.put(1)
    q.shutdown(force=False)  # no blocked consumers → returns promptly
    import pytest as _pytest

    from ray_tpu_torch.core.exceptions import ActorDiedError

    with _pytest.raises(Exception):
        q.get_nowait()


# ------------------------------------------------------------- dask shim
def test_ray_dask_get_plain_graph(cluster):
    """ray_dask_get executes a hand-built dask-protocol graph over
    cluster tasks (reference ray.util.dask scheduler)."""
    from operator import add, mul

    from ray_tpu_torch.util.dask import ray_dask_get

    dsk = {
        "a": 2,
        "b": (mul, "a", 3),             # 6
        "c": (add, "a", "b"),           # 8
        "d": (sum, ["a", "b", "c"]),    # 16 (list-nested deps)
    }
    assert ray_dask_get(dsk, ["d", "c"]) == [16, 8]
    assert ray_dask_get(dsk, "b") == 6


def test_ray_dask_get_with_dask_if_available(cluster):
    try:
        import dask
    except ImportError:
        import pytest

        pytest.skip("dask not installed")
    import dask.delayed

    from ray_tpu_torch.util.dask import ray_dask_get

    @dask.delayed
    def inc(x):
        return x + 1

    total = inc(1) + inc(2)
    assert total.compute(scheduler=ray_dask_get) == 5


def test_ray_dask_cycle_detection(cluster):
    import pytest

    from ray_tpu_torch.util.dask import ray_dask_get

    with pytest.raises(ValueError, match="cycle"):
        ray_dask_get({"a": (len, "b"), "b": (len, "a")}, "a")


# ----------------------------------------------------------- usage stats
def test_usage_stats_opt_in_file_reporter(cluster, monkeypatch, tmp_path):
    from ray_tpu_torch.core import config as _config
    from ray_tpu_torch.util import usage_stats as us

    # disabled by default: no thread
    assert not us.start_usage_stats_heartbeat("s1", interval_s=0.1)
    monkeypatch.setenv("RAY_TPU_USAGE_STATS", "1")
    got = []
    us.record_library_usage("train")
    us.record_library_usage("serve")
    us.record_extra_usage_tag("test", "yes")
    assert us.start_usage_stats_heartbeat("s1", interval_s=0.05,
                                          reporter=got.append)
    import time as _time

    deadline = _time.time() + 5
    while not got and _time.time() < deadline:
        _time.sleep(0.05)
    us.stop_usage_stats_heartbeat()
    assert got, "reporter never fired"
    payload = got[0]
    assert payload["source"] == "ray_tpu_torch"
    assert "train" in payload["library_usages"]
    assert payload["extra_usage_tags"]["test"] == "yes"
    assert payload["session_id"] == "s1"


# ------------------------------------------------- parity with ray_tpu
def _seeded_graph():
    """A dask-protocol graph over seeded numpy data: sums, products,
    list-nested deps."""
    import numpy as np

    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(64), rng.standard_normal(64)
    return {"x": x, "y": y,
            "xy": (np.multiply, "x", "y"),
            "s": (np.sum, "xy"),
            "m": (np.maximum, "x", "y"),
            "t": (sum, ["s", (np.sum, "m"), 1.5])}


@pytest.fixture(scope="module")
def jax_cluster(cluster):
    """The JAX package's single-node cluster beside the port's (each
    package keeps its own client; neither writes the environment)."""
    import ray_tpu

    ray_tpu.init(num_cpus=2, num_tpu_chips=0, max_workers=4)
    try:
        yield ray_tpu
    finally:
        ray_tpu.shutdown()


def test_ray_dask_get_parity_with_jax_package(cluster, jax_cluster):
    import numpy as np
    from ray_tpu.util.dask import ray_dask_get as jax_dask_get

    from ray_tpu_torch.util.dask import ray_dask_get

    keys = ["t", "s", "m", "xy"]
    port = ray_dask_get(_seeded_graph(), keys)
    ref = jax_dask_get(_seeded_graph(), keys)
    for p, r in zip(port, ref):
        assert np.array_equal(np.asarray(p), np.asarray(r))


def test_usage_stats_and_timeline_keys_match_jax_package(
        cluster, jax_cluster, monkeypatch):
    """The usage-stats payload and timeline()'s Chrome trace carry the
    same keys in both packages; the port's head writes its opt-in
    heartbeat as JSON lines under the port's state directory."""
    import json
    import os

    from ray_tpu.util import usage_stats as jax_us
    from ray_tpu.util.timeline import timeline as jax_timeline

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import usage_stats as us
    from ray_tpu_torch.utils.platform import STATE_DIR

    monkeypatch.setenv("RAY_TPU_USAGE_STATS", "1")
    got = []
    assert jax_us.start_usage_stats_heartbeat("s-jax", interval_s=60,
                                              reporter=got.append)
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.05)
    jax_us.stop_usage_stats_heartbeat()
    assert got
    # the port's head starts its heartbeat at boot (opted in by the env)
    path = os.path.join(STATE_DIR, "usage_stats.jsonl")
    c = Cluster(num_cpus=1)
    try:
        deadline = time.monotonic() + 20
        lines = []
        while time.monotonic() < deadline:
            if os.path.exists(path):
                lines = [json.loads(ln) for ln in open(path)
                         if c.session in ln]
            if lines:
                break
            time.sleep(0.1)
    finally:
        c.shutdown()
    assert c.processes() == [] and c.segments() == []
    assert lines, "the head wrote no usage-stats line"
    assert lines[0]["session_id"] == c.session
    assert lines[0]["source"] == "ray_tpu_torch"
    assert sorted(lines[0]) == sorted(got[0])

    def trace_keys(pkg, tl):
        @pkg.remote
        def work(i):
            return i + 1

        assert pkg.get([work.remote(i) for i in range(4)],
                       timeout=60) == [1, 2, 3, 4]
        deadline = time.monotonic() + 20
        while True:
            doc = tl(None, format="chrome")
            tasks = [e for e in doc if e.get("cat") == "task"]
            if len(tasks) >= 4 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        return sorted(tasks[0]), sorted(tasks[0]["args"])

    import ray_tpu

    assert trace_keys(ray_tpu_torch, ray_tpu_torch.timeline) == \
        trace_keys(ray_tpu, jax_timeline)
