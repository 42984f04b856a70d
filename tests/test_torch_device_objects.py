"""Device objects in the port: the device store and the device transport.

The port's mirror of `tests/test_device_store.py` (5 cases) and
`tests/test_device_transport.py` (6 cases) on CPU tensors, bf16 included,
against `ray_tpu_torch`: `put_device` keeps a tensor in its process
(same-process `get` returns it, the same `data_ptr`), an actor method with
`tensor_transport="device"` hands its result over, a consumer in another
process gets an equal tensor through a shm snapshot whose meta stays small,
and the snapshot is staged once and freed with the object. Beside the
mirror:

- concurrent fetchers share one staging;
- an in-place write by one consumer never reaches the next consumer's copy
  (a CPU consumer pays one copy; torch has no read-only tensor);
- a get across nodes under store isolation (`cluster_utils`), bit-equal
  through the chunked pull;
- the gang route over a gloo `DistCollectiveGroup` met through the
  runtime (the mirror of `tests/test_collective_multihost.py`'s device
  fetch and stale-membership cases): leaves ride gloo, the owner stages no
  snapshot; a stale membership falls back to the snapshot; a peer that
  never sends surfaces ObjectLostError within `ici_fetch_timeout_s`.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import ObjectLostError

MB = 1 << 20


@pytest.fixture(scope="module")
def cluster():
    os.environ["RAY_TPU_EVICT_GRACE_S"] = "0"
    try:
        ray_tpu_torch.init(num_cpus=6, num_gpus=0, max_workers=10)
        yield
        ray_tpu_torch.shutdown()
    finally:
        os.environ.pop("RAY_TPU_EVICT_GRACE_S", None)


def _client():
    from ray_tpu_torch.core.api import _global_client

    return _global_client()


def _ref(hex_id):
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef

    return ObjectRef(ObjectID.from_hex(hex_id))


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()


@ray_tpu_torch.remote
class Owner:
    def put_array(self, mb, dtype="float32"):
        x = torch.arange(mb * MB // 4, dtype=torch.float32).to(
            getattr(torch, dtype))
        self._ref = ray_tpu_torch.put_device(x)
        return self._ref.hex()

    def put_tree(self):
        x = {"w": torch.ones((128, 128), dtype=torch.float32),
             "b": torch.full((64,), 1.5, dtype=torch.bfloat16),
             "meta": {"step": 7, "name": "tree"},
             "host": np.arange(10)}
        self._ref = ray_tpu_torch.put_device(x)
        return self._ref.hex()

    def drop(self):
        self._ref = None
        gc.collect()
        return True

    def stats(self):
        from ray_tpu_torch.core import device_transport as dt

        return {**dict(dt.STATS),
                "device_objects": len(_client().device_store),
                "cached_snapshots": len(_client()._device_snapshots)}


# ------------------------------------------------- device store (5 cases)
def test_same_process_zero_copy(cluster):
    """put_device + get in one process returns the LIVING tensor: no host
    round trip, the same object and the same data pointer."""
    t = torch.arange(4096, dtype=torch.float32) * 2.0
    ref = ray_tpu_torch.put_device(t)
    got = ray_tpu_torch.get(ref)
    assert got is t
    assert got.data_ptr() == t.data_ptr()
    del ref


def test_cross_process_fetch_rematerializes(cluster):
    """A consumer task in another process receives an equal tensor."""
    @ray_tpu_torch.remote
    def consume(box):
        val = ray_tpu_torch.get(box["r"])
        assert isinstance(val, torch.Tensor)
        return float(val.sum())

    t = torch.ones((1024,), dtype=torch.float32) * 3.0
    ref = ray_tpu_torch.put_device(t)
    assert ray_tpu_torch.get(consume.remote({"r": ref}),
                             timeout=60) == 3.0 * 1024
    del ref


def test_actor_device_method_handoff(cluster):
    """Actor -> driver and actor -> actor tensor handoff through
    @ray_tpu_torch.method(tensor_transport="device")."""
    @ray_tpu_torch.remote
    class Producer:
        @ray_tpu_torch.method(tensor_transport="device")
        def weights(self):
            self._w = torch.full((512,), 7.0, dtype=torch.float32)
            return self._w

        def same(self, box):
            return ray_tpu_torch.get(box["r"]) is self._w

    @ray_tpu_torch.remote
    class Consumer:
        def total(self, box):
            return float(ray_tpu_torch.get(box["r"]).sum())

    p, c = Producer.remote(), Consumer.remote()
    ref = p.weights.remote()
    val = ray_tpu_torch.get(ref, timeout=60)
    assert isinstance(val, torch.Tensor) and float(val[0]) == 7.0
    assert ray_tpu_torch.get(c.total.remote({"r": ref}),
                             timeout=60) == 7.0 * 512
    # the owner's own get is the living tensor
    assert ray_tpu_torch.get(p.same.remote({"r": ref}), timeout=60)
    ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(c)


def test_device_object_freed_with_refs(cluster):
    """Dropping every ref releases the owner-side value (refcount-driven
    free_device_object)."""
    client = _client()
    ref = ray_tpu_torch.put_device(torch.zeros((2048,)))
    oid = ref.id
    assert client.device_store.contains(oid)
    del ref
    gc.collect()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if not client.device_store.contains(oid):
            return
        time.sleep(0.2)
    raise AssertionError("device object not released after refs dropped")


def test_numpy_passthrough(cluster):
    """put_device of a value that is not a tensor round-trips too."""
    data = {"w": np.ones((256,), dtype=np.float32)}
    ref = ray_tpu_torch.put_device(data)
    assert ray_tpu_torch.get(ref) is data
    del ref


# --------------------------------------------- device transport (6 cases)
def test_cross_process_get_no_pickle_hot_path(cluster):
    """The bulk bytes of a cross-process device get() never pass through a
    pickle stream; the snapshot of a 4 MiB tensor keeps its meta under
    4096 bytes with buffers covering its bytes, as the JAX package's does
    for a 4 MiB array (its own target, checked here side by side)."""
    import jax.numpy as jnp

    from ray_tpu.core import serialization as jser
    from ray_tpu_torch.core import serialization

    owner = Owner.remote()
    ref = _ref(ray_tpu_torch.get(owner.put_array.remote(32), timeout=60))
    val = ray_tpu_torch.get(ref, timeout=60)
    assert val.shape == (32 * MB // 4,)
    assert torch.equal(val[:5], torch.arange(5.0))
    for t in (torch.ones(MB), torch.ones(2 * MB, dtype=torch.bfloat16)):
        ser = serialization.serialize(t, device_snapshot=True)
        assert len(ser.meta) < 4096, "tensor bytes leaked into the stream"
        assert sum(b.nbytes for b in ser.buffers) >= 4 * MB
    want = jser.serialize(jnp.ones(MB), device_snapshot=True)
    assert len(want.meta) < 4096
    assert sum(b.nbytes for b in want.buffers) >= 4 * MB
    del ref, val
    gc.collect()
    ray_tpu_torch.kill(owner)


def test_pytree_remat_and_host_leaves(cluster):
    """Tensor leaves come back as tensors (on this CPU-only consumer's
    default device, the CPU), bf16 included; numpy and Python leaves come
    back untouched."""
    owner = Owner.remote()
    ref = _ref(ray_tpu_torch.get(owner.put_tree.remote(), timeout=60))
    val = ray_tpu_torch.get(ref, timeout=60)
    assert isinstance(val["w"], torch.Tensor) and val["w"].shape == (128, 128)
    assert val["b"].dtype == torch.bfloat16 and float(val["b"][0]) == 1.5
    assert isinstance(val["host"], np.ndarray)
    assert val["meta"] == {"step": 7, "name": "tree"}
    del ref, val
    gc.collect()
    ray_tpu_torch.kill(owner)


def test_snapshot_cached_and_freed_with_object(cluster):
    """Repeated consumers reuse one staged snapshot; the snapshot's shm
    dies with the device object."""
    from ray_tpu_torch.core.device_transport import snapshot_oid
    from ray_tpu_torch.core.ids import ObjectID

    owner = Owner.remote()
    hex_id = ray_tpu_torch.get(owner.put_array.remote(8), timeout=60)
    ref = _ref(hex_id)
    a = ray_tpu_torch.get(ref, timeout=60)
    b = ray_tpu_torch.get(ref, timeout=60)
    assert torch.equal(a, b)
    st = ray_tpu_torch.get(owner.stats.remote(), timeout=60)
    assert st["snapshots_staged"] == 1 and st["cached_snapshots"] == 1
    snap_hex = snapshot_oid(ObjectID.from_hex(hex_id)).hex()
    del a, b, ref
    gc.collect()
    assert ray_tpu_torch.get(owner.drop.remote(), timeout=60)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        st = ray_tpu_torch.get(owner.stats.remote(), timeout=60)
        objs = {o["object_id"] for o in _client().head_request(
            "list_state", kind="objects")}
        if (hex_id not in objs and st["device_objects"] == 0
                and st["cached_snapshots"] == 0):
            break
        time.sleep(0.2)
    else:
        raise AssertionError(f"device object never freed: {st}")
    assert snap_hex not in objs
    ray_tpu_torch.kill(owner)


def test_same_process_get_is_zero_copy_identity(cluster):
    t = torch.arange(16.0)
    ref = ray_tpu_torch.put_device(t)
    assert ray_tpu_torch.get(ref) is t
    del ref
    gc.collect()


def test_remat_leaf_on_a_cpu_consumer_copies_once():
    """The counterpart of the JAX package's DLPack adoption case: a CPU
    consumer's leaf is a tensor with the view's bytes in memory of its own
    (a `jax.Array` is immutable and may alias the mapped view; a tensor is
    not, so it is copied once), and a plain host read outside the context
    is a zero-copy view."""
    from ray_tpu_torch.core import device_transport as dt

    src = np.arange(4096, dtype=np.float32)
    with dt.rematerialize_context():
        t = dt._remat_leaf(src.view(np.uint8), "float32", (4096,), True)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert torch.equal(t, torch.from_numpy(src))
    assert t.data_ptr() != src.ctypes.data, "the leaf aliased the view"
    view = dt._remat_leaf(src.view(np.uint8), "float32", (4096,), True)
    assert view.data_ptr() == src.ctypes.data


def test_remat_leaf_ignores_device_dlpack(cluster):
    """device_dlpack=0 changes nothing on the torch side (no adoption to
    turn off): the leaf is still an equal tensor of its own."""
    from ray_tpu_torch.core import config as _config
    from ray_tpu_torch.core import device_transport as dt

    _config.GLOBAL.set("device_dlpack", False)
    try:
        src = np.arange(64, dtype=np.float32)
        with dt.rematerialize_context():
            t = dt._remat_leaf(src.view(np.uint8), "float32", (64,), False)
        assert torch.equal(t, torch.from_numpy(src))
        assert t.data_ptr() != src.ctypes.data
    finally:
        _config.GLOBAL._overrides.pop("device_dlpack", None)


# ------------------------------------------------------------ beside it
def test_concurrent_fetchers_share_one_staging(cluster):
    """Six consumers in other processes and the driver, all at once: the
    owner stages ONE snapshot (one staging task shared by concurrent
    fetchers), and every consumer gets the same bytes."""
    @ray_tpu_torch.remote
    def digest(box):
        return _bits(ray_tpu_torch.get(box["r"]))[::4099]

    owner = Owner.remote()
    ref = _ref(ray_tpu_torch.get(owner.put_array.remote(16, "bfloat16"),
                                 timeout=60))
    futs = [digest.remote({"r": ref}) for _ in range(6)]
    mine = _bits(ray_tpu_torch.get(ref, timeout=60))[::4099]
    assert all(d == mine for d in ray_tpu_torch.get(futs, timeout=120))
    st = ray_tpu_torch.get(owner.stats.remote(), timeout=60)
    assert st["snapshots_staged"] == 1, st
    del ref
    ray_tpu_torch.kill(owner)


def test_in_place_write_never_reaches_the_next_consumer(cluster):
    """A consumer that writes into its tensor in place does not change
    what a later consumer (the same process or another) gets: no consumer
    holds an alias of the cached snapshot."""
    @ray_tpu_torch.remote
    def scribble(box):
        t = ray_tpu_torch.get(box["r"])
        t.mul_(-1.0)
        return float(t.sum())

    owner = Owner.remote()
    ref = _ref(ray_tpu_torch.get(owner.put_array.remote(1), timeout=60))
    want = float(torch.arange(MB // 4, dtype=torch.float32).sum())
    assert ray_tpu_torch.get(scribble.remote({"r": ref}), timeout=60) == -want
    first = ray_tpu_torch.get(ref, timeout=60)
    first.add_(1.0)
    assert ray_tpu_torch.get(scribble.remote({"r": ref}), timeout=60) == -want
    assert float(ray_tpu_torch.get(ref, timeout=60).sum()) == want
    del ref, first
    ray_tpu_torch.kill(owner)


# ------------------------------------------------------------ gang route
@ray_tpu_torch.remote
class GangMember:
    def __init__(self, world, rank, name):
        from ray_tpu_torch.util.collective import collective as col

        self.rank, self.name = rank, name
        col.init_collective_group(world, rank, "gloo", name)

    def put_value(self):
        self.value = {"w": torch.arange(64.0).reshape(8, 8) + 100 * self.rank,
                      "b": torch.full((5,), 2.5, dtype=torch.bfloat16),
                      "tag": f"rank{self.rank}", "host": np.arange(3)}
        # the actor HOLDS the ref: dropping it would race refcount eviction
        # against the consumer's get
        self._ref = ray_tpu_torch.put_device(self.value)
        return self._ref.hex()

    def get_value(self, hex_id, timeout_s=None):
        from ray_tpu_torch.core import config as _config

        if timeout_s is not None:
            _config.GLOBAL.set("ici_fetch_timeout_s", timeout_s)
        t0 = time.monotonic()
        try:
            val = ray_tpu_torch.get(_ref(hex_id), timeout=120)
        except ObjectLostError as e:
            return {"lost": repr(e), "s": time.monotonic() - t0}
        return {"w": _bits(val["w"]), "b": _bits(val["b"]),
                "b_dtype": str(val["b"].dtype), "tag": val["tag"],
                "host": val["host"].tolist()}

    def drop_sends(self):
        from ray_tpu_torch.core import config as _config

        _config.GLOBAL.set("testing_ici_drop_send", True)
        return True

    def staged_snapshots(self):
        from ray_tpu_torch.core import device_transport as dt

        return (dt.STATS["snapshots_staged"],
                len(_client()._device_snapshots))

    def worker_id(self):
        return _client().worker_id.hex()


def _want(rank):
    return {"w": _bits(torch.arange(64.0).reshape(8, 8) + 100 * rank),
            "b": _bits(torch.full((5,), 2.5, dtype=torch.bfloat16)),
            "b_dtype": "torch.bfloat16", "tag": f"rank{rank}",
            "host": [0, 1, 2]}


def test_device_object_fetch_over_the_gang(cluster):
    """get() of a gang peer's device object rides the group (gloo here,
    NCCL on the card): the values arrive bit-equal, the owner stages no
    snapshot. With its sends dropped (the chaos hook), the get raises
    ObjectLostError within `ici_fetch_timeout_s` instead of hanging."""
    members = [GangMember.remote(2, r, "gang_dev") for r in range(2)]
    hex_id = ray_tpu_torch.get(members[0].put_value.remote(), timeout=120)
    out = ray_tpu_torch.get(members[1].get_value.remote(hex_id), timeout=120)
    assert out == _want(0)
    assert ray_tpu_torch.get(members[0].staged_snapshots.remote(),
                             timeout=60) == (0, 0)
    # the owner "crashes" between its reply and its sends
    assert ray_tpu_torch.get(members[0].drop_sends.remote(), timeout=60)
    t0 = time.monotonic()
    out = ray_tpu_torch.get(members[1].get_value.remote(hex_id, 3.0),
                            timeout=120)
    assert "never sent within 3.0s" in out.get("lost", ""), out
    assert out["s"] < 20 and time.monotonic() - t0 < 60
    for m in members:
        ray_tpu_torch.kill(m)


def test_stale_membership_falls_back_to_snapshot(cluster):
    """A membership record claiming the OWNER is in our gang when it is
    not (a group destroyed owner-side only, a replaced process): the owner
    answers the gang fetch with None and the consumer falls back to the
    shm snapshot, value intact, no hang."""
    import pickle

    from ray_tpu_torch.util.collective.dist_group import _MEMBER_NS

    @ray_tpu_torch.remote
    class PlainOwner:
        def put_value(self):
            self._ref = ray_tpu_torch.put_device(
                {"w": torch.ones((4, 4)) * 7, "b": torch.zeros(2),
                 "tag": "plain", "host": np.arange(3)})
            return self._ref.hex(), _client().worker_id.hex()

    owner = PlainOwner.remote()
    hex_id, owner_wid = ray_tpu_torch.get(owner.put_value.remote(),
                                          timeout=120)
    consumers = [GangMember.remote(2, r, "gang_stale") for r in range(2)]
    ray_tpu_torch.get([c.staged_snapshots.remote() for c in consumers],
                      timeout=120)
    _client().kv_put(_MEMBER_NS, owner_wid.encode(), pickle.dumps(
        {"group": "gang_stale", "rank": 0, "world": 2}), overwrite=True)
    out = ray_tpu_torch.get(consumers[1].get_value.remote(hex_id),
                            timeout=120)
    assert out["w"] == _bits(torch.ones((4, 4)) * 7) and out["tag"] == "plain"
    for a in [owner] + consumers:
        ray_tpu_torch.kill(a)


def test_device_store_helpers_without_torch_loaded():
    """The device store never imports torch: a process without it sizes
    numpy trees and holds values all the same."""
    import subprocess
    import sys

    code = ("import sys, numpy as np\n"
            "from ray_tpu_torch.core import device_store as ds\n"
            "s = ds.DeviceObjectStore()\n"
            "from ray_tpu_torch.core.ids import ObjectID\n"
            "n = s.put(ObjectID.generate(), {'a': np.ones(4), 'b': "
            "[np.ones(2, np.int8)]})\n"
            "print(n, ds.is_device_value(np.ones(1)), 'torch' in "
            "sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["34", "False", "False"]


def test_device_leaf_buffer_writes_straight_into_the_store(cluster):
    """A CUDA leaf's out-of-band buffer (`DeviceLeafBuffer`, here over a
    CPU tensor: the same code without a card) is copied once, straight
    into the range the store reserved for it, arena or inline, and
    counted; the frame reads back bit-equal."""
    from ray_tpu_torch.core import device_transport as dt
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.serialization import SerializedObject

    t = torch.arange(MB, dtype=torch.float32).to(torch.bfloat16)
    store = _client().store
    before = dt.STATS["d2h_copies"]
    for n in (t, t[:100]):          # 2 MiB into the arena; 200 B inline
        ser = SerializedObject(b"meta", [dt.DeviceLeafBuffer(n)])
        meta = store.put_serialized(ObjectID.generate(), ser)
        assert (meta.kind == "inline") == (n.numel() == 100), meta.kind
        back = store.get_serialized(meta)
        assert bytes(back.buffers[0]) == _bits(n)
        store.release(meta)
        store.delete_unregistered(meta)
    assert dt.STATS["d2h_copies"] == before + 2


def test_staging_shared_by_threads_of_one_consumer(cluster):
    """Concurrent gets from threads of ONE process (the driver) also share
    one staging, and the owner's count says so."""
    owner = Owner.remote()
    ref = _ref(ray_tpu_torch.get(owner.put_array.remote(4), timeout=60))
    outs = []

    def go():
        outs.append(_bits(ray_tpu_torch.get(ref, timeout=60))[::997])

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(outs) == 4 and len(set(outs)) == 1
    st = ray_tpu_torch.get(owner.stats.remote(), timeout=60)
    assert st["snapshots_staged"] == 1, st
    del ref
    ray_tpu_torch.kill(owner)


# runs last: it replaces the module's runtime with a cluster of its own
def test_device_object_across_nodes_under_isolation(cluster):
    """Store isolation: a device object owned on node A is got bit-equal
    on node B through the chunked pull, and by the driver."""
    from ray_tpu_torch.cluster_utils import Cluster

    # needs its own cluster: the module's runtime goes first (its
    # fixture's shutdown is then a no-op)
    ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = Cluster(num_cpus=0)
    try:
        c.add_node(num_cpus=2, resources={"nodeA": 4})
        c.add_node(num_cpus=2, resources={"nodeB": 4})
        c.connect()
        c.wait_for_nodes(3)

        @ray_tpu_torch.remote(resources={"nodeA": 1})
        class A:
            def put(self):
                g = torch.Generator().manual_seed(1)
                self.t = torch.randn(3 * MB, generator=g).to(torch.bfloat16)
                self._ref = ray_tpu_torch.put_device(self.t)
                return self._ref.hex(), _bits(self.t)[::1031]

        @ray_tpu_torch.remote(resources={"nodeB": 1})
        def on_b(box):
            t = ray_tpu_torch.get(box["r"], timeout=60)
            return t.dtype == torch.bfloat16, _bits(t)[::1031]

        a = A.remote()
        hex_id, want = ray_tpu_torch.get(a.put.remote(), timeout=120)
        ok, got = ray_tpu_torch.get(on_b.remote({"r": _ref(hex_id)}),
                                    timeout=120)
        assert ok and got == want
        assert _bits(ray_tpu_torch.get(_ref(hex_id), timeout=60))[::1031] \
            == want
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
    assert c.processes() == [] and c.segments() == []
