"""Lineage reconstruction: lost objects are rebuilt by re-running their
producing task.

The port's mirror of `tests/test_lineage.py`, against `ray_tpu_torch`;
each cluster must leave no process and no `rtpt_*` segment of its
session behind.

Mirrors the reference's object recovery
(`src/ray/core_worker/object_recovery_manager.cc` + TaskManager lineage):
node dies → its objects' metas drop → a consumer get() triggers task
resubmission; first-seal-wins makes racing consumers safe.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


def _assert_clean(c):
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()


@pytest.fixture()
def cluster():
    c = Cluster(num_cpus=1)
    c.add_node(num_cpus=2, resources={"pin": 2})
    c.connect()
    c.wait_for_nodes(2)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()
    _assert_clean(c)


@ray_tpu_torch.remote(resources={"pin": 1}, num_cpus=1)
def produce(tag):
    # large enough to live in shm (not inlined in the meta)
    return np.full((256, 1024), tag, dtype=np.float32)


def test_object_reconstructed_after_node_death(cluster):
    ref = produce.remote(7)
    first = ray_tpu_torch.get(ref, timeout=60)
    assert first[0, 0] == 7

    # kill the node holding the object's data; meta is dropped on the head
    cluster.kill_node(0)
    time.sleep(1.0)
    # bring back capacity with the pinned resource so the producing task can
    # re-run somewhere (the reference reconstructs onto surviving nodes)
    cluster.add_node(num_cpus=2, resources={"pin": 2})
    cluster.wait_for_nodes(2)

    again = ray_tpu_torch.get(ref, timeout=120)
    assert again.shape == (256, 1024) and again[0, 0] == 7


def test_dependent_task_triggers_reconstruction(cluster):
    ref = produce.remote(3)
    ray_tpu_torch.get(ref, timeout=60)
    cluster.kill_node(0)
    time.sleep(1.0)
    cluster.add_node(num_cpus=2, resources={"pin": 2})
    cluster.wait_for_nodes(2)

    @ray_tpu_torch.remote(num_cpus=1)
    def consume(arr):
        return float(arr.sum())

    # the dependency is lost; enqueue must reconstruct it first
    out = ray_tpu_torch.get(consume.remote(ref), timeout=120)
    assert out == 3.0 * 256 * 1024


def test_freed_objects_stay_freed(cluster):
    ref = produce.remote(1)
    ray_tpu_torch.get(ref, timeout=60)
    ray_tpu_torch.free([ref])
    time.sleep(0.5)
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=5)


@ray_tpu_torch.remote(resources={"pin": 1}, num_cpus=1)
def split_halves(arr):
    # multi-return producer: two shm-sized sub-blocks from one input
    n = arr.shape[0] // 2
    return arr[:n].copy(), arr[n:].copy()


def test_multi_return_sibling_free_keeps_lineage_pin(cluster):
    """Multi-return refcount x lineage interaction: dropping ONE
    sub-block ref evicts that sub-block but must keep the shared lineage
    entry's input pin alive for the sibling — after node loss, the
    sibling reconstructs by re-running the producer against the
    still-pinned input."""
    import gc

    arr = np.arange(128 * 1024, dtype=np.float32)  # 512 KB: shm halves
    xref = ray_tpu_torch.put(arr.copy())
    ref_a, ref_b = split_halves.options(num_returns=2).remote(xref)
    a = ray_tpu_torch.get(ref_a, timeout=60)
    b = ray_tpu_torch.get(ref_b, timeout=60)
    assert np.array_equal(np.concatenate([a, b]), arr)
    # drop the driver's handles to sub-block A and the INPUT: the only
    # thing keeping the input alive now is the sibling entry's dep pin
    del a, ref_a, xref
    gc.collect()
    time.sleep(1.0)   # ref flush + evict loop

    cluster.kill_node(0)
    time.sleep(1.0)
    cluster.add_node(num_cpus=2, resources={"pin": 2})
    cluster.wait_for_nodes(2)

    again = ray_tpu_torch.get(ref_b, timeout=120)
    assert np.array_equal(again, b), "sibling reconstruction corrupted"


def test_cap_evicted_lineage_entry_raises_not_hangs():
    """A lost object whose lineage entry was cap-evicted before
    reconstruction must surface ObjectLostError promptly — never park a
    consumer forever."""
    import os

    from ray_tpu_torch.core.exceptions import ObjectLostError

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_LINEAGE_CAP"] = "6"
    try:
        c = Cluster(num_cpus=1)
        c.add_node(num_cpus=2, resources={"pin": 2})
        c.connect()
        c.wait_for_nodes(2)
        try:
            ref = produce.remote(5)
            ray_tpu_torch.get(ref, timeout=60)

            @ray_tpu_torch.remote(num_cpus=1)
            def tiny(i):
                return i

            # flood the bounded ledger: produce's entry FIFO-evicts
            ray_tpu_torch.get([tiny.remote(i) for i in range(10)], timeout=60)
            c.kill_node(0)
            time.sleep(1.0)
            t0 = time.time()
            with pytest.raises(ObjectLostError):
                ray_tpu_torch.get(ref, timeout=60)
            assert time.time() - t0 < 30, "loss surfaced only at timeout"
        finally:
            ray_tpu_torch.shutdown()
            c.shutdown()
        _assert_clean(c)
    finally:
        os.environ.pop("RAY_TPU_LINEAGE_CAP", None)


def test_lost_put_object_raises_not_hangs(cluster):
    """ray.put objects have no lineage; losing their node must raise
    ObjectLostError for parked waiters, never hang (regression)."""
    import threading

    from ray_tpu_torch.core.exceptions import ObjectLostError

    @ray_tpu_torch.remote(resources={"pin": 1}, num_cpus=1)
    class Holder:
        def make(self):
            import ray_tpu_torch as rt

            return rt.put(np.zeros((256, 1024), np.float32))

    h = Holder.remote()
    ref = ray_tpu_torch.get(h.make.remote(), timeout=60)

    got = {}

    def getter():
        try:
            got["val"] = ray_tpu_torch.get(ref, timeout=90)
        except Exception as e:
            got["err"] = e

    # drop the only copy's metadata by killing the node, while a consumer
    # is already parked waiting — but first drop local caches so the driver
    # actually re-asks the head
    client = ray_tpu_torch.core.api._global_client()
    client.local_metas.pop(ref.id, None)
    cluster.kill_node(0)
    time.sleep(1.0)
    t = threading.Thread(target=getter)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "get() hung on a lost, lineage-less object"
    assert "err" in got and isinstance(got["err"], ObjectLostError), got
