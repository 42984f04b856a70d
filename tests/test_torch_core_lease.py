"""Lease-style direct task push: steady-state tasks bypass the head.

The port's mirror of `tests/test_lease.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Parity target: the reference's NormalTaskSubmitter lease protocol
(`src/ray/core_worker/task_submission/normal_task_submitter.cc:328`
RequestWorkerLease, `:515` PushNormalTask): after the head grants a
worker for a task shape, the client pushes subsequent same-shape tasks
straight to that worker and the head is out of the loop — no fan-in
bottleneck at the head.
"""

import os
import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    os.environ["RAY_TPU_EVICT_GRACE_S"] = "0"
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
        yield
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_EVICT_GRACE_S", None)


@ray_tpu_torch.remote
def square(x):
    return x * x


@ray_tpu_torch.remote
def add(a, b):
    return a + b


def _client():
    from ray_tpu_torch.core.api import _global_client

    return _global_client()


def test_lease_engages_and_results_correct(cluster):
    # warm: first submissions go via the head while the lease is acquired
    assert ray_tpu_torch.get(square.remote(7), timeout=30) == 49
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not _client()._leases:
        ray_tpu_torch.get(square.remote(2), timeout=30)
    assert _client()._leases, "lease never established"
    # steady state: a burst of same-shape tasks rides the lease
    refs = [square.remote(i) for i in range(200)]
    assert ray_tpu_torch.get(refs, timeout=60) == [i * i for i in range(200)]


def test_lease_tasks_with_ref_args(cluster):
    """Deps resolve on the leased worker; caller-held pins keep them alive
    (same discipline as direct actor calls) at zero eviction grace."""
    import gc

    import numpy as np

    big = ray_tpu_torch.put(np.full(300_000, 2, dtype=np.uint8))
    # warm the lease for `add`'s shape
    assert ray_tpu_torch.get(add.remote(1, 2), timeout=30) == 3

    @ray_tpu_torch.remote
    def total(arr):
        return int(arr.sum())

    assert ray_tpu_torch.get(total.remote(big), timeout=30) == 600_000
    refs = [total.remote(big) for _ in range(20)]
    del big
    gc.collect()
    assert ray_tpu_torch.get(refs, timeout=60) == [600_000] * 20


def test_lease_released_when_idle(cluster):
    """An idle client hands its leased workers back to the pool."""
    assert ray_tpu_torch.get(square.remote(3), timeout=30) == 9
    for _ in range(50):
        ray_tpu_torch.get(square.remote(3), timeout=30)
        if _client()._leases:
            break
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if not _client()._leases:
            return
        time.sleep(0.25)
    raise AssertionError("lease never released after idling")


def test_lease_worker_death_falls_back(cluster):
    """Killing the leased worker mid-burst must not lose tasks: the client
    resubmits through the head."""
    # establish a lease
    for _ in range(50):
        ray_tpu_torch.get(square.remote(1), timeout=30)
        if _client()._leases:
            break
    leases = dict(_client()._leases)
    assert leases
    import os as _os
    import signal

    # find the leased worker's pid via the head state API
    workers = _client().head_request("list_state", kind="workers")
    leased_ids = {l.worker_id.hex() for l in leases.values()}
    victims = [w for w in workers if w["worker_id"] in leased_ids]
    refs = [square.remote(i) for i in range(50)]
    for v in victims:
        try:
            _os.kill(v["pid"], signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert ray_tpu_torch.get(refs, timeout=120) == [i * i for i in range(50)]


def test_lease_result_registered_and_reclaimed(cluster):
    """Regression: a lease-path task result above the
    inline threshold must be registered with the head — otherwise the
    consumer's ref-drop writes a tombstone and the bytes leak in the
    worker's arena forever. Asserts both halves: the result appears in
    the head directory, and dropping the ref evicts it."""
    import gc

    import numpy as np

    @ray_tpu_torch.remote
    def big_result(n):
        return np.ones((n,), dtype=np.uint8)

    # establish a lease for this shape
    assert int(ray_tpu_torch.get(big_result.remote(8), timeout=30).sum()) == 8
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not _client()._leases:
        ray_tpu_torch.get(big_result.remote(8), timeout=30)
    assert _client()._leases, "lease never established"

    ref = big_result.remote(300_000)  # > inline threshold: lands in shm
    assert int(ray_tpu_torch.get(ref, timeout=30).sum()) == 300_000

    def _object_ids():
        return {o["object_id"] for o in _client().head_request(
            "list_state", kind="objects")}

    oid = ref.hex()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and oid not in _object_ids():
        time.sleep(0.1)
    assert oid in _object_ids(), \
        "lease-path result never registered with the head (leak)"
    del ref
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and oid in _object_ids():
        time.sleep(0.1)
    assert oid not in _object_ids(), "dropped lease result not evicted"
