"""Cross-node object data plane tests.

The port's mirror of `tests/test_object_transfer.py`, against
`ray_tpu_torch`, with torch tensors (f32 and bf16) returned on one node
and got on another, bit-equal and out of band. Each cluster must leave no
process and no `rtpt_*` segment of its session behind (under isolation
every node's arena and segments carry its own namespace).

Store isolation mode gives every node its own shm namespace and makes
stores REFUSE to read foreign segments, so a single-machine cluster
faithfully reproduces real multi-host object movement: every cross-node
read must travel through the node data servers (chunked pull), exactly
what the reference's object manager does over gRPC
(`src/ray/object_manager/object_manager.h`, `pull_manager.h:49`).

The second half exercises the peer-to-peer data plane: the gossiped
object directory (warm remote get() with zero head RPCs), the daemon
pull manager (one network crossing per node regardless of how many local
workers consume an object), chunk retry under seeded chaos on the data
edge, and head-restart survival of shm-sized objects (daemons
re-advertise their inventory through the reconcile handshake).
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.exceptions import GetTimeoutError, ObjectLostError


def _assert_clean(c):
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()


@pytest.fixture(scope="module")
def iso_cluster():
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    try:
        c = Cluster(num_cpus=0)  # head schedules nothing itself
        c.add_node(num_cpus=2, resources={"nodeA": 4})
        c.add_node(num_cpus=2, resources={"nodeB": 4})
        c.connect()
        c.wait_for_nodes(3)
        yield c
        ray_tpu_torch.shutdown()
        c.shutdown()
        _assert_clean(c)
    finally:
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)


@ray_tpu_torch.remote
def make_array(mb, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(mb * 1024 * 1024,), dtype=np.uint8)


@ray_tpu_torch.remote
def checksum(arr):
    return int(arr[::4096].astype(np.uint64).sum()), arr.shape[0]


@ray_tpu_torch.remote
def make_tensor(dtype_name, n, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g).to(getattr(torch, dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_torch_tensor_across_nodes(iso_cluster, dtype_name):
    """A torch tensor returned by a task on node A reaches the driver
    (the head's store namespace) through the chunked data plane:
    bit-equal, and its bytes out of band (one buffer of exactly the
    tensor's bytes beside a small pickle)."""
    import torch

    n = 1 << 20
    ref = make_tensor.options(resources={"nodeA": 1}).remote(
        dtype_name, n, 7)
    got = ray_tpu_torch.get(ref, timeout=120)
    want = torch.randn(n, generator=torch.Generator().manual_seed(7)).to(
        getattr(torch, dtype_name))
    assert got.dtype == want.dtype and got.device.type == "cpu"
    bits = torch.int32 if dtype_name == "float32" else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    client = ray_tpu_torch.core.api._global_client()
    local = client._pulled.get(ref.id) or client._daemon_pulled.get(ref.id)
    assert local is not None, "the object was not pulled across nodes"
    ser = client.store.get_serialized(local)
    assert len(ser.meta) < 1024, len(ser.meta)
    assert [b.nbytes for b in ser.buffers] == [want.numel()
                                               * want.element_size()]


def test_remote_task_result_pull(iso_cluster):
    """Driver get() of a result produced on an isolated worker node."""
    ref = make_array.options(resources={"nodeA": 1}).remote(8, 1)
    arr = ray_tpu_torch.get(ref, timeout=60)
    expect = np.random.default_rng(1).integers(
        0, 255, size=(8 * 1024 * 1024,), dtype=np.uint8)
    assert arr.shape == expect.shape and np.array_equal(arr, expect)


def test_put_consumed_on_remote_node(iso_cluster):
    """Driver put() consumed as a task arg on another node (args payload
    goes through the store and must be pulled by the executing worker)."""
    rng = np.random.default_rng(7)
    big = rng.integers(0, 255, size=(4 * 1024 * 1024,), dtype=np.uint8)
    ref = ray_tpu_torch.put(big)
    s, n = ray_tpu_torch.get(
        checksum.options(resources={"nodeB": 1}).remote(ref), timeout=60)
    assert n == big.shape[0]
    assert s == int(big[::4096].astype(np.uint64).sum())


def test_node_to_node_transfer(iso_cluster):
    """Result produced on node A consumed by a task on node B."""
    ref = make_array.options(resources={"nodeA": 1}).remote(6, 3)
    s, n = ray_tpu_torch.get(
        checksum.options(resources={"nodeB": 1}).remote(ref), timeout=60)
    expect = np.random.default_rng(3).integers(
        0, 255, size=(6 * 1024 * 1024,), dtype=np.uint8)
    assert n == expect.shape[0]
    assert s == int(expect[::4096].astype(np.uint64).sum())


def test_multi_chunk_large_object(iso_cluster):
    """An object spanning many transfer chunks (default 4 MiB) survives
    reassembly bit-exactly."""
    ref = make_array.options(resources={"nodeB": 1}).remote(48, 11)
    arr = ray_tpu_torch.get(ref, timeout=120)
    expect = np.random.default_rng(11).integers(
        0, 255, size=(48 * 1024 * 1024,), dtype=np.uint8)
    assert np.array_equal(arr, expect)


def test_actor_reply_cross_node(iso_cluster):
    """Direct actor replies carry unregistered metas; cross-node consumers
    resolve the producer's data server from the meta's node stamp."""

    @ray_tpu_torch.remote
    class Producer:
        def big(self):
            return np.full((3 * 1024 * 1024,), 42, dtype=np.uint8)

    p = Producer.options(resources={"nodeA": 1}).remote()
    arr = ray_tpu_torch.get(p.big.remote(), timeout=60)
    assert arr.shape == (3 * 1024 * 1024,) and int(arr[0]) == 42 \
        and int(arr[-1]) == 42
    ray_tpu_torch.kill(p)


def test_wait_then_get_remote(iso_cluster):
    refs = [make_array.options(resources={"nodeA": 1}).remote(2, s)
            for s in (21, 22)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=2, timeout=60)
    assert len(ready) == 2 and not pending
    for s, r in zip((21, 22), refs):
        arr = ray_tpu_torch.get(r, timeout=60)
        expect = np.random.default_rng(s).integers(
            0, 255, size=(2 * 1024 * 1024,), dtype=np.uint8)
        assert np.array_equal(arr, expect)


def test_free_remote_object(iso_cluster):
    """free() of a remote object reaches the owning node; later gets fail
    rather than returning stale data."""
    ref = make_array.options(resources={"nodeB": 1}).remote(2, 31)
    assert ray_tpu_torch.get(ref, timeout=60).shape == (2 * 1024 * 1024,)
    ray_tpu_torch.free([ref])
    with pytest.raises((ObjectLostError, GetTimeoutError)):
        ray_tpu_torch.get(ref, timeout=2)


def test_pull_cache_reuse(iso_cluster):
    """Second get() of the same remote object reuses the pulled copy (no
    error, identical contents)."""
    ref = make_array.options(resources={"nodeA": 1}).remote(3, 41)
    a1 = ray_tpu_torch.get(ref, timeout=60)
    a2 = ray_tpu_torch.get(ref, timeout=60)
    assert np.array_equal(a1, a2)


# ------------------------------------------------ peer-to-peer data plane
def _wait_directory_warm(client, oid, timeout=20):
    """Wait until the driver's cached directory can resolve oid to a node
    whose data address the cached view knows — the all-from-cache state."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        locs = client.object_dir.locations(oid)
        if locs and any(client.cluster_view.data_addr_of(h) for h in locs):
            return True
        time.sleep(0.05)
    return False


def test_warm_remote_get_makes_zero_head_rpcs(iso_cluster):
    """Head-free steady state (acceptance): once the gossiped directory
    and cluster view are warm, a node-to-node get() of a remote shm
    object performs ZERO head round trips — location, meta, and the pull
    itself all resolve from cache (interposer-verified, same style as
    test_warm_lease_path_makes_zero_head_rpcs)."""
    client = ray_tpu_torch.core.api._global_client()
    ref = make_array.options(resources={"nodeA": 1}).remote(3, 77)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert _wait_directory_warm(client, ref.id), "directory never warmed"
    time.sleep(0.3)  # let registration/refcount stragglers flush

    events = []

    def hook(conn_name, kind, method):
        if conn_name == "head":
            events.append((kind, method))

    protocol.add_rpc_interposer(hook)
    try:
        arr = ray_tpu_torch.get(ref, timeout=60)
    finally:
        protocol.remove_rpc_interposer(hook)
    expect = np.random.default_rng(77).integers(
        0, 255, size=(3 * 1024 * 1024,), dtype=np.uint8)
    assert np.array_equal(arr, expect)
    reqs = [m for k, m in events if k == "req"]
    assert not reqs, f"warm remote get made head round trips: {reqs}"
    pushes = {m for k, m in events if k == "push"}
    assert pushes <= {"ref_update", "metrics_push"}, \
        f"warm remote get pushed more than telemetry: {pushes}"


def test_node_pull_manager_dedups_worker_pulls(iso_cluster):
    """Two workers on one node consuming the same remote object cost ONE
    network crossing: worker pulls route through the node daemon's pull
    manager, whose in-flight dedup + replica cache serve every local
    consumer from the node store."""
    from ray_tpu_torch.util import state

    def daemon_pulls():
        rows = [r for r in state.list_scheduler_stats()
                if not r.get("is_head")
                and r.get("object_pulls") is not None]
        return (sum(r["object_pulls"] for r in rows),
                sum(r.get("object_pull_bytes", 0) for r in rows),
                len(rows))

    # earlier tests in this module also pulled through the daemons:
    # settle and snapshot the counters, then diff
    deadline = time.time() + 25
    while time.time() < deadline and daemon_pulls()[2] < 2:
        time.sleep(0.25)
    base_pulls, base_bytes, nrows = daemon_pulls()
    assert nrows >= 2, "daemons never gossiped pull stats"

    ref = make_array.options(resources={"nodeA": 1}).remote(5, 51)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=60)

    @ray_tpu_torch.remote
    def consume(arr, tag):
        return int(arr[::4096].astype(np.uint64).sum()), tag

    # two concurrent consumers on nodeB (it has 2 CPUs)
    out = ray_tpu_torch.get([
        consume.options(resources={"nodeB": 1}).remote(ref, t)
        for t in range(2)], timeout=120)
    expect = np.random.default_rng(51).integers(
        0, 255, size=(5 * 1024 * 1024,), dtype=np.uint8)
    want = int(expect[::4096].astype(np.uint64).sum())
    assert out == [(want, 0), (want, 1)]

    # the daemons gossip their pull counters on the metrics cadence
    deadline = time.time() + 25
    while time.time() < deadline:
        pulls, bytes_, _ = daemon_pulls()
        if pulls > base_pulls:
            break
        time.sleep(0.25)
    assert pulls - base_pulls == 1, \
        f"object crossed the network {pulls - base_pulls} times"
    assert bytes_ - base_bytes >= 5 * 1024 * 1024


@pytest.mark.chaos
def test_large_pull_survives_chaos_on_data_edge(iso_cluster):
    """A seeded drop+delay plan on the data edge (fetch_chunk) is
    absorbed by the pull manager's chunk retry/backoff — the large object
    still arrives bit-exact, and the injected faults are observable."""
    ref = make_array.options(resources={"nodeB": 1}).remote(16, 61)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=120)
    client = ray_tpu_torch.core.api._global_client()
    client._drop_pulled(ref.id)
    protocol.configure_chaos(
        "seed=5,drop:fetch_chunk@data-*:every=3,"
        "delay:fetch_chunk@data-*:p=0.25:t=0.02")
    try:
        arr = ray_tpu_torch.get(ref, timeout=180)
    finally:
        protocol.configure_chaos("")
    expect = np.random.default_rng(61).integers(
        0, 255, size=(16 * 1024 * 1024,), dtype=np.uint8)
    assert np.array_equal(arr, expect)


@pytest.fixture()
def restart_cluster():
    """Function-scoped isolated cluster whose head we can SIGKILL."""
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    try:
        c = Cluster(num_cpus=0, enable_snapshots=True)
        c.add_node(num_cpus=2, resources={"nodeA": 4})
        c.add_node(num_cpus=2, resources={"nodeB": 4})
        c.connect()
        c.wait_for_nodes(3)
        yield c
        ray_tpu_torch.shutdown()
        c.shutdown()
        _assert_clean(c)
    finally:
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)


@pytest.mark.chaos
def test_head_sigkill_mid_pull_and_shm_restart_drill(restart_cluster):
    """The restart acceptance drill, shm-sized (NOT inline): (1) a head
    SIGKILL mid-pull does not disturb the transfer — data rides direct
    daemon connections resolved from the gossiped directory; (2) after
    the head restarts, surviving daemons re-advertise their object
    inventory through the reconcile handshake, the head directory is
    rebuilt, and a cache-cleared get() pulls the object peer-to-peer."""
    cluster = restart_cluster
    client = ray_tpu_torch.core.api._global_client()
    ref = make_array.options(resources={"nodeA": 1}).remote(24, 91)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=120)
    assert _wait_directory_warm(client, ref.id), "directory never warmed"
    expect = np.random.default_rng(91).integers(
        0, 255, size=(24 * 1024 * 1024,), dtype=np.uint8)

    # slow each chunk so the head dies mid-transfer (6 chunks à 4 MiB,
    # window 4: the transfer spans ~0.5s of injected delay)
    protocol.configure_chaos("delay:fetch_chunk@data-*:t=0.25")
    box = {}

    def _get():
        try:
            box["arr"] = ray_tpu_torch.get(ref, timeout=180)
        except BaseException as e:  # surfaced to the main thread below
            box["err"] = e

    t = threading.Thread(target=_get, daemon=True)
    try:
        t.start()
        time.sleep(0.3)  # pull in flight (first chunks still delayed)
        cluster.kill_head()
        t.join(timeout=180)
    finally:
        protocol.configure_chaos("")
    assert not t.is_alive(), "pull hung after head SIGKILL"
    assert "err" not in box, box.get("err")
    assert np.array_equal(box["arr"], expect)

    # -- restart: daemons reconcile and re-advertise their inventory
    cluster.restart_head(restore=True)
    from ray_tpu_torch.util import state

    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            rows = state.list_scheduler_stats()
            if sum(1 for r in rows if not r.get("is_head")
                   and r.get("reconciled")) >= 2:
                break
        except Exception:
            pass
        time.sleep(0.25)
    else:
        raise AssertionError("daemons never reconciled with restarted head")

    # the head's object directory must know the object again (rebuilt
    # from daemon truth, not from any client cache)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            objs = {o["object_id"]: o for o in state.list_objects()}
            row = objs.get(ref.id.hex())
            # re-advertised from the daemon: full-size shm/spilled entry,
            # not an inline tombstone
            if row is not None and row["size"] >= expect.nbytes:
                break
        except Exception:
            pass
        time.sleep(0.25)
    else:
        raise AssertionError("restarted head never relearned the object")

    # cache-cleared consumer: drop every driver-side shortcut, then get()
    # — resolution rides the (rebuilt) directory and the pull is P2P
    client._drop_pulled(ref.id)
    client.local_metas.pop(ref.id, None)
    arr = ray_tpu_torch.get(ref, timeout=120)
    assert np.array_equal(arr, expect)


@pytest.mark.chaos
def test_replica_serves_after_primary_node_death(restart_cluster):
    """A pulled replica outlives its primary: once nodeB's pull manager
    caches (and advertises) a copy, SIGKILLing nodeA does not lose the
    object — the directory keeps the entry (surviving replica), and a
    cache-cleared get() fails over to nodeB, whose data server
    translates the canonical meta to its local replica by object id."""
    cluster = restart_cluster
    client = ray_tpu_torch.core.api._global_client()
    node_a = cluster._node_ids[0]

    ref = make_array.options(resources={"nodeA": 1}).remote(4, 33)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    expect = np.random.default_rng(33).integers(
        0, 255, size=(4 * 1024 * 1024,), dtype=np.uint8)

    # a nodeB worker consumes the object: its daemon pulls + caches a
    # replica and announces it into the gossiped directory
    @ray_tpu_torch.remote
    def digest(arr):
        return int(arr[::4096].astype(np.uint64).sum())

    want = int(expect[::4096].astype(np.uint64).sum())
    assert ray_tpu_torch.get(digest.options(resources={"nodeB": 1}).remote(ref),
                       timeout=120) == want
    deadline = time.time() + 30
    while time.time() < deadline:
        if len(client.object_dir.locations(ref.id)) >= 2:
            break
        time.sleep(0.2)
    else:
        raise AssertionError("replica never advertised into the directory")

    cluster.kill_node(node_a)
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        if len(alive) == 2:  # head + nodeB
            break
        time.sleep(0.2)
    client._drop_pulled(ref.id)
    client.local_metas.pop(ref.id, None)
    arr = ray_tpu_torch.get(ref, timeout=120)
    assert np.array_equal(arr, expect)
