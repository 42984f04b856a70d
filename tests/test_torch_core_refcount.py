"""Automatic object lifetime via distributed reference counting.

The port's mirror of `tests/test_refcount.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Reference parity target: `src/ray/core_worker/reference_count.h:73` —
objects live while any process holds an ObjectRef, an in-flight task
references them, a live container object embeds them, or a
reconstructable lineage entry needs them; `free()` is optional.

Beyond the mirror: an actor-call result the driver holds and hands to a
second actor survives that actor's inc and dec reaching the head before
the driver's own batched inc (the JAX package's head evicts it then, and
a later call taking the ref waits forever for its meta; the port's
driver registers itself as a holder when it registers the ref).
"""

import gc
import os
import time

import numpy as np
import pytest

import ray_tpu_torch

ARR = 200 * 1024  # > inline threshold: objects land in shm


@pytest.fixture(scope="module")
def cluster():
    # ZERO grace: lifetime must be fully explicit (holders + pins +
    # borrows); any correctness-by-timing regression fails this module
    os.environ["RAY_TPU_EVICT_GRACE_S"] = "0"
    os.environ["RAY_TPU_REFCOUNT_FLUSH_S"] = "0.05"
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
        yield
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_EVICT_GRACE_S", None)
        os.environ.pop("RAY_TPU_REFCOUNT_FLUSH_S", None)


def _object_ids():
    from ray_tpu_torch.core.api import _global_client

    return {o["object_id"] for o in _global_client().head_request(
        "list_state", kind="objects")}


def _wait_gone(oid_hex, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if oid_hex not in _object_ids():
            return True
        time.sleep(0.1)
    return False


def _wait_alive_steady(oid_hex, hold=1.0):
    """Object must still be in the directory after `hold` seconds (i.e.
    well past the eviction grace)."""
    time.sleep(hold)
    return oid_hex in _object_ids()


@ray_tpu_torch.remote
def produce():
    return np.ones((ARR,), dtype=np.uint8)


@ray_tpu_torch.remote
def sum_nested(d):
    # nested refs are not auto-resolved (reference semantics: only
    # top-level args are); the executing worker gets them explicitly
    return int(ray_tpu_torch.get(d["x"]).sum())


def test_put_then_drop_evicts(cluster):
    ref = ray_tpu_torch.put(np.ones((ARR,), dtype=np.uint8))
    oid = ref.hex()
    assert _wait_alive_steady(oid)
    del ref
    gc.collect()
    assert _wait_gone(oid)


def test_held_ref_is_never_evicted(cluster):
    ref = ray_tpu_torch.put(np.ones((ARR,), dtype=np.uint8))
    oid = ref.hex()
    time.sleep(1.5)  # several grace windows
    assert oid in _object_ids()
    assert int(ray_tpu_torch.get(ref).sum()) == ARR
    del ref


def test_task_result_evicted_after_drop(cluster):
    ref = produce.remote()
    assert int(ray_tpu_torch.get(ref, timeout=30).sum()) == ARR
    oid = ref.hex()
    del ref
    gc.collect()
    assert _wait_gone(oid)


def test_nested_ref_pinned_by_container(cluster):
    inner = ray_tpu_torch.put(np.full((ARR,), 3, dtype=np.uint8))
    outer = ray_tpu_torch.put({"x": inner})
    inner_oid = inner.hex()
    del inner
    gc.collect()
    # containment pin: well past the grace window, still alive
    assert _wait_alive_steady(inner_oid)
    got = ray_tpu_torch.get(outer)["x"]
    assert int(ray_tpu_torch.get(got).sum()) == 3 * ARR
    del got
    outer_oid = outer.hex()
    del outer
    gc.collect()
    assert _wait_gone(outer_oid)
    assert _wait_gone(inner_oid)


def test_nested_ref_in_task_args_pinned(cluster):
    inner = ray_tpu_torch.put(np.full((ARR,), 2, dtype=np.uint8))
    ref = sum_nested.remote({"x": inner})
    del inner  # only the in-flight task references it now
    gc.collect()
    assert ray_tpu_torch.get(ref, timeout=30) == 2 * ARR
    del ref


def test_ref_in_actor_state_pins(cluster):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self, box):
            self.r = box["r"]  # nested: arrives as a live ObjectRef

        def read(self):
            return int(ray_tpu_torch.get(self.r).sum())

    inner = ray_tpu_torch.put(np.full((ARR,), 5, dtype=np.uint8))
    h = Holder.remote({"r": inner})
    # wait for the actor to be constructed (it then holds the ref)
    assert ray_tpu_torch.get(h.read.remote(), timeout=30) == 5 * ARR
    inner_oid = inner.hex()
    del inner
    gc.collect()
    assert _wait_alive_steady(inner_oid)
    assert ray_tpu_torch.get(h.read.remote(), timeout=30) == 5 * ARR
    ray_tpu_torch.kill(h)
    # once the actor process dies, nothing holds the object
    assert _wait_gone(inner_oid, timeout=15)


def test_nested_ref_in_actor_reply_pinned(cluster):
    """Refs embedded in a direct actor REPLY must survive the producer
    dropping its own refs (containment registers the reply with the head)."""

    @ray_tpu_torch.remote
    class Maker:
        def make(self):
            inner = ray_tpu_torch.put(np.full((ARR,), 6, dtype=np.uint8))
            return {"x": inner}  # actor drops its local ref on return

    m = Maker.remote()
    box = ray_tpu_torch.get(m.make.remote(), timeout=30)
    time.sleep(1.5)  # several grace windows after the producer's drop
    assert int(ray_tpu_torch.get(box["x"], timeout=30).sum()) == 6 * ARR
    ray_tpu_torch.kill(m)


def test_manual_free_still_immediate(cluster):
    ref = ray_tpu_torch.put(np.ones((ARR,), dtype=np.uint8))
    oid = ref.hex()
    ray_tpu_torch.free([ref])
    assert _wait_gone(oid, timeout=5)


def test_borrowed_ref_parked_out_of_band(cluster):
    """Adversarial handoff: a ref is pickled into raw bytes, parked in the
    KV, and the sender drops every local ref. Long after any grace window
    the bytes are deserialized and the object must still be alive —
    the borrow pin opened at pickle time is what holds it."""
    import pickle

    from ray_tpu_torch.core.api import _global_client

    client = _global_client()
    ref = ray_tpu_torch.put(np.full((ARR,), 9, dtype=np.uint8))
    oid = ref.hex()
    blob = pickle.dumps({"parked": ref})
    client.kv_put("test", b"parked_ref", blob)
    del ref
    gc.collect()
    time.sleep(3.0)  # far beyond flush interval + any grace
    assert oid in _object_ids(), "borrow pin must outlive the sender's refs"
    revived = pickle.loads(client.kv_get("test", b"parked_ref"))["parked"]
    assert int(ray_tpu_torch.get(revived, timeout=30).sum()) == 9 * ARR
    del revived
    gc.collect()
    # commit released the borrow; dropping the revived ref frees the object
    assert _wait_gone(oid)


def test_borrow_released_on_sender_death(cluster):
    """A process that serialized a ref and died releases its borrow pins:
    parked handoffs from dead senders must not leak forever."""

    @ray_tpu_torch.remote
    class Parker:
        def park(self):
            r = ray_tpu_torch.put(np.ones((ARR,), dtype=np.uint8))
            import pickle

            from ray_tpu_torch.core.api import _global_client

            _global_client().kv_put("test", b"dead_sender", pickle.dumps(r))
            return r.hex()

    p = Parker.remote()
    oid = ray_tpu_torch.get(p.park.remote(), timeout=30)
    assert _wait_alive_steady(oid)  # borrow pin holds it
    ray_tpu_torch.kill(p)
    assert _wait_gone(oid, timeout=15)


def test_soak_directory_stays_bounded(cluster):
    """Many dropped results with zero free() calls: the object directory
    must not grow monotonically (a soak criterion)."""
    for _ in range(120):
        r = produce.remote()
        assert int(ray_tpu_torch.get(r, timeout=30).sum()) == ARR
        del r
    gc.collect()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if len(_object_ids()) <= 20:
            return
        time.sleep(0.25)
    raise AssertionError(f"directory still has {len(_object_ids())} objects")


def test_handed_on_result_survives_a_faster_borrower(cluster):
    """The driver holds an actor-call result R and passes it to actor B;
    B's inc and dec reach the head while the driver's own inc is still
    batched (this process flushes its transitions 1 s late here). R must
    stay: the next call that takes it resolves at once."""
    import torch

    from ray_tpu_torch.core import refcount

    @ray_tpu_torch.remote
    class Holder:
        def make(self):
            return torch.arange(ARR // 4, dtype=torch.float32)

        def total(self, x):
            return float(x.sum())

    a, b = Holder.remote(), Holder.remote()
    ray_tpu_torch.get([a.total.remote(torch.ones(1)),
                       b.total.remote(torch.ones(1))], timeout=60)
    want = float(torch.arange(ARR // 4, dtype=torch.float32).sum())
    orig = refcount._flush_s
    refcount._flush_s = lambda: 1.0
    try:
        time.sleep(0.3)   # a flush already scheduled at the old pace fires
        r = a.make.remote()
        assert ray_tpu_torch.get(b.total.remote(r), timeout=60) == want
        time.sleep(0.5)   # B's transitions have landed, ours have not
        assert ray_tpu_torch.get(a.total.remote(r), timeout=10) == want
    finally:
        refcount._flush_s = orig
        ray_tpu_torch.kill(a)
        ray_tpu_torch.kill(b)
