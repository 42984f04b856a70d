"""The port's fault-tolerant streaming data plane, and its batches against
the JAX package's.

The mirror of `tests/test_data_pipeline.py`, case for case, on the port
(`ray_tpu_torch.data`, `ray_tpu_torch.train.ingest`): inter-stage blocks on
the P2P object plane (warm handoff with zero head RPCs), lineage-driven
recovery (a node SIGKILLed mid-shuffle), live-signal backpressure, eager
release of consumed intermediates, and the continuous-ingest drill (Data
feeding the trainer across an elastic resize, no batch duplicated or
dropped). Every isolation cluster is checked at teardown for leftover
processes and `rtpt_*` segments.

Beside the mirror, parity with the JAX package (`ray_tpu.data`) on the same
seeded numpy inputs: `from_numpy` -> `map_batches` (a task stage and an
actor-pool stage) -> `random_shuffle(seed)` -> `sort` / `groupby` / `zip`,
and `DatasetShard` at world 1, 2 and 4, give bit-equal batches in both
packages, locally (no runtime) and each on its own running cluster. The JAX
package is imported inside those tests only, so a port worker that imports
this module by reference never loads JAX.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.exceptions import ObjectLostError
from ray_tpu_torch.data import shuffle as shf
from ray_tpu_torch.data.executor import Stage, StreamingExecutor, TaskStage


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
    yield info
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass


def _iso_cluster(extra_env=None, nodes=2, node_kw=None):
    # the module-scope cluster (if any earlier test used it) must not
    # bleed into an isolation drill's runtime
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    for k, v in (extra_env or {}).items():
        os.environ[k] = v
    c = Cluster(num_cpus=0)
    kw = node_kw or [{"num_cpus": 2, "resources": {"nodeA": 4}},
                     {"num_cpus": 2, "resources": {"nodeB": 4}}][:nodes]
    nids = [c.add_node(**k) for k in kw]
    c.connect()
    c.wait_for_nodes(nodes + 1)
    return c, nids


def _iso_teardown(c, extra_env=None):
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass
    c.shutdown()
    os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
    for k in (extra_env or {}):
        os.environ.pop(k, None)
    assert c.processes() == [] and c.segments() == [], (c.processes(),
                                                         c.segments())


def _head_stat(key):
    from ray_tpu_torch.util import state

    for row in state.list_scheduler_stats():
        if row.get("is_head"):
            return row.get(key, 0)
    return 0


def _node_stat(node_hex, key):
    from ray_tpu_torch.util import state

    for row in state.list_scheduler_stats():
        if row.get("node_id") == node_hex:
            return row.get(key)
    return None


# ------------------------------------------------ parity with ray_tpu.data
def _parity_outputs(rd, DatasetShard):
    """Every pipeline of the parity case, run through one package's data
    library: {name: list of numpy batches (column dicts)}. The UDFs are
    defined here so they ship by value."""
    rng = np.random.default_rng(7)
    n = 96
    cols = {"x": rng.integers(0, 1 << 20, n).astype(np.int64),
            "k": rng.integers(0, 5, n).astype(np.int64),
            "v": rng.normal(0.0, 1.0, n)}

    class Scale:
        def __call__(self, batch):
            return {"x": batch["x"], "k": batch["k"],
                    "v": batch["v"] * 3.0 + 0.5}

    ds = (rd.from_numpy(cols, parallelism=4)
          .map_batches(lambda b: {"x": b["x"] * 3 + 1, "k": b["k"],
                                  "v": b["v"]})
          .map_batches(Scale, concurrency=2)
          .random_shuffle(seed=11))
    out = {"shuffled": list(ds.iter_batches(batch_size=16)),
           "sorted": list(ds.sort("x").iter_batches(batch_size=16)),
           "sorted_desc": list(ds.sort("v", descending=True)
                               .iter_batches(batch_size=16)),
           "groupby": sorted(
               ds.groupby("k").aggregate(("v", "sum"), ("v", "mean"),
                                         ("x", "max")).take_all(),
               key=lambda r: int(r["k"])),
           "zip": list(ds.zip(rd.from_numpy(
               {"y": np.arange(n, dtype=np.int64) * 2}, parallelism=3))
                       .iter_batches(batch_size=32))}
    for world in (1, 2, 4):
        for rank in range(world):
            out[f"shard{rank}/{world}"] = [
                (gi, b) for gi, b in DatasetShard(ds, rank, world)
                .iter_global_batches(batch_size=24)]
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            if isinstance(b, tuple):     # (global index, batch)
                assert a[0] == b[0], name
                a, b = a[1], b[1]
            assert set(a) == set(b), name
            for col in b:
                x, y = np.asarray(a[col]), np.asarray(b[col])
                assert x.dtype == y.dtype and x.shape == y.shape, (name, col)
                assert x.tobytes() == y.tobytes(), (name, col)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX package's batches, locally and on its own cluster (started
    and stopped here, before any port runtime of this module)."""
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu.train.ingest import DatasetShard as JShard

    local = _parity_outputs(jdata, JShard)
    ray_tpu.init(num_cpus=4, num_tpu_chips=0, max_workers=6)
    try:
        remote = _parity_outputs(jdata, JShard)
    finally:
        ray_tpu.shutdown()
    return local, remote


@pytest.mark.parametrize("where", ["local", "cluster"])
def test_pipeline_batches_equal_jax_package(jax_outputs, where):
    from ray_tpu_torch.train.ingest import DatasetShard

    want_local, want_remote = jax_outputs
    if where == "local":
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        got = _parity_outputs(rdata, DatasetShard)
        _assert_same(got, want_local)
    else:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
        try:
            got = _parity_outputs(rdata, DatasetShard)
        finally:
            ray_tpu_torch.shutdown()
        _assert_same(got, want_remote)
    # the shuffle's order is the seed's, not the runtime's
    _assert_same({"shuffled": got["shuffled"]},
                 {"shuffled": want_local["shuffled"]})
    # a shard's rows are its window of the global batch
    for world in (2, 4):
        for gi, whole in got["shard0/1"]:
            parts = [dict(got[f"shard{r}/{world}"])[gi]
                     for r in range(world)]
            assert np.array_equal(np.concatenate([p["x"] for p in parts]),
                                  whole["x"])


# -------------------------------------------- trainer ingest (unit level)
def test_dataset_shard_global_batches_world_agnostic():
    """DatasetShard contract: global batch i is the same rows at every
    world size; rank slices union to exactly the global batch; and
    start_batch resumes mid-stream without duplication."""
    from ray_tpu_torch.train.ingest import DatasetShard

    ds = rdata.range(64, parallelism=4)
    ref = list(DatasetShard(ds, 0, 1).iter_batches(batch_size=8))
    assert len(ref) == 8
    # world 2: per-rank halves of each global batch concatenate to it
    r0 = list(DatasetShard(ds, 0, 2).iter_batches(batch_size=8))
    r1 = list(DatasetShard(ds, 1, 2).iter_batches(batch_size=8))
    for gi in range(8):
        merged = np.concatenate([r0[gi]["id"], r1[gi]["id"]])
        assert (merged == ref[gi]["id"]).all()
    # resume at start_batch=5 yields exactly the remaining global batches
    resumed = list(DatasetShard(ds, 0, 1).iter_batches(
        batch_size=8, start_batch=5))
    assert [list(b["id"]) for b in resumed] == \
        [list(b["id"]) for b in ref[5:]]
    with pytest.raises(ValueError):
        next(iter(DatasetShard(ds, 0, 3).iter_batches(batch_size=8)))


# ----------------------------------------------- executor lost-input retry
@ray_tpu_torch.remote
def _raise_lost(_ref=None):
    from ray_tpu_torch.core.exceptions import ObjectLostError

    raise ObjectLostError("synthetic input loss")


@ray_tpu_torch.remote
def _double(block):
    return {"id": np.asarray(block["id"]) * 2}


class _FlakyStage(Stage):
    """Consumer stage whose FIRST attempt per partition surfaces
    ObjectLostError (as a real remote task result), like a consumer whose
    input died mid-flight; retries succeed."""

    def __init__(self):
        super().__init__("flaky", max_in_flight=4)
        self._seen = set()

    def submit(self, ref):
        key = ref if not hasattr(ref, "id") else ref.id
        if key not in self._seen:
            self._seen.add(key)
            return _raise_lost.remote(ref)
        return _double.remote(ref)


def test_executor_retries_consumer_on_lost_input(cluster):
    """A consumer task that surfaces ObjectLostError is retried by the
    executor (rides lineage reconstruction of the input) instead of
    failing the pipeline."""
    n = 4
    parts = [(lambda i=i: {"id": np.arange(10) + 10 * i}) for i in range(n)]
    s0 = TaskStage([])
    s1 = _FlakyStage()
    ex = StreamingExecutor([s0, s1], parts, lambda: 4)
    got = {}
    for idx, ref in ex.run():
        got[idx] = ray_tpu_torch.get(ref, timeout=60)
    assert sorted(got) == list(range(n))
    for i in range(n):
        assert (got[i]["id"] == (np.arange(10) + 10 * i) * 2).all()
    assert s1.stats.retried == n
    assert ex.input_retries == n


def test_executor_propagates_nonretryable_errors(cluster):
    """User-code failures are NOT retried as lost inputs — they surface
    to the consumer unchanged."""

    @ray_tpu_torch.remote
    def boom(_):
        raise ValueError("user bug")

    class Boom(Stage):
        def __init__(self):
            super().__init__("boom", max_in_flight=2)

        def submit(self, ref):
            return boom.remote(ref)

    ex = StreamingExecutor(
        [TaskStage([]), Boom()],
        [lambda: {"id": np.arange(4)}], lambda: 2)
    (idx, ref), = list(ex.run())
    with pytest.raises(Exception, match="user bug"):
        ray_tpu_torch.get(ref, timeout=60)
    assert ex.input_retries == 0


# ----------------------------------------------------------- backpressure
def test_backpressure_queue_sheds_upstream_admission(cluster):
    """A slow downstream stage (cap 1) backs its queue up to the bound;
    the UPSTREAM stage gets throttled instead of racing ahead — the
    degraded-stage contract."""

    @ray_tpu_torch.remote
    def slow(block):
        time.sleep(0.15)
        return block

    class SlowStage(Stage):
        def __init__(self):
            super().__init__("slow", max_in_flight=1)

        def submit(self, ref):
            return slow.remote(ref)

    n = 8
    parts = [(lambda i=i: {"id": np.arange(8) + i}) for i in range(n)]
    # stage-0 cap of 2 means admission happens across many ticks — the
    # congested downstream queue must visibly stop it
    s0 = TaskStage([], max_in_flight=2)
    s1 = SlowStage()
    ex = StreamingExecutor([s0, s1], parts, lambda: n)
    out = list(ex.run())
    assert len(out) == n
    assert s0.stats.throttled > 0, "upstream admission never shed"
    # the downstream queue never grew past its bound: upstream completed
    # blocks parked in stage-1's queue are capped at 2x its concurrency
    # (asserted indirectly: stage-0 in-flight + queue was capped, so the
    # pipeline cannot have buffered everything at once)


def test_backpressure_store_pressure_stops_input_admission(cluster):
    """Gossiped store-pressure rows above the highwater stop stage-0
    admission; when pressure clears, the pipeline completes. Signal
    injected through the real ClusterView API the executor consults."""
    from ray_tpu_torch.core.api import _global_client

    client = _global_client()
    orig = client.cluster_view.max_store_frac
    client.cluster_view.max_store_frac = lambda: 0.99
    try:
        ds = rdata.range(64, parallelism=4)
        box = {}

        def run():
            box["rows"] = ds.count()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(1.0)
        assert "rows" not in box, "pipeline ran under store pressure"
        ex = ds._last_executor
        assert ex is not None and ex.stages[0].stats.submitted == 0
        assert ex.stages[0].stats.throttled > 0
    finally:
        client.cluster_view.max_store_frac = orig
    t.join(timeout=60)
    assert box.get("rows") == 64, "pipeline never completed after clear"


def test_cluster_view_max_store_frac_reads_entries():
    from ray_tpu_torch.core.resource_view import ClusterView, make_entry

    v = ClusterView()
    v.entries["a"] = make_entry("a", version=1, free={}, total={},
                                labels={}, store_frac=0.2)
    v.entries["b"] = make_entry("b", version=1, free={}, total={},
                                labels={}, store_frac=0.9)
    v.entries["c"] = make_entry("c", version=1, free={}, total={},
                                labels={})  # unknown store
    assert v.max_store_frac() == 0.9


# ----------------------------------------------------------- eager release
def test_eager_release_bounds_store_footprint(cluster):
    """Consumed intermediate blocks release their lineage
    entries and evict while the pipeline still runs — live store bytes
    stay bounded by the in-flight window, far below the total bytes the
    pipeline produces."""
    from ray_tpu_torch.core.api import _global_client

    client = _global_client()
    lock = threading.Lock()
    live = {}
    track = {"peak": 0, "total": 0, "evicted": 0}
    LO, HI = 200 * 1024, 4 << 20

    def on_state(msg):
        with lock:
            oid = msg.get("object_id")
            if msg.get("state") == "SEALED":
                size = msg.get("size") or 0
                if LO <= size <= HI:
                    live[oid] = size
                    track["total"] += size
                    track["peak"] = max(track["peak"],
                                        sum(live.values()))
            elif msg.get("state") == "EVICTED":
                if live.pop(oid, None) is not None:
                    track["evicted"] += 1

    client.subscribe_channel("object_state", on_state)
    try:
        class Ident:
            def __call__(self, batch):
                time.sleep(0.3)  # realistic stage work: early partitions
                return batch     # finish while later ones still stream

        # 12 partitions x 3 stages of ~0.5 MB blocks, window fixed at 2
        ds = (rdata.range(1200, parallelism=12)
              .map_batches(lambda b: {
                  "id": b["id"],
                  "x": np.ones((len(b["id"]), 640), np.float64)})
              .map_batches(Ident, concurrency=1)
              .map_batches(lambda b: {"id": b["id"], "x": b["x"] + 1}))
        ds._parallelism = 2
        assert ds.count() == 1200
        # give refcount flush + evict loop a beat to drain the tail
        deadline = time.time() + 10
        while time.time() < deadline:
            with lock:
                if not live:
                    break
            time.sleep(0.2)
    finally:
        client.unsubscribe_channel("object_state", on_state)
    with lock:
        peak, total, evicted = (track["peak"], track["total"],
                                track["evicted"])
    assert total > 8 << 20, f"pipeline produced too little ({total})"
    assert peak < total * 0.55, (
        f"peak live bytes {peak} not bounded vs total {total} — "
        "intermediates are not releasing eagerly")
    assert evicted >= 18, f"only {evicted} blocks evicted"


# ------------------------------------- warm inter-stage handoff (P2P plane)
@ray_tpu_torch.remote
def _make_block_probe(rows, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((rows, 64))}


def test_dep_metas_ride_lease_specs(cluster):
    """The driver ships known non-inline dep metas with lease specs so
    the executing worker skips get_meta (unit: helper contract).
    NOTE: keep this (and every `cluster`-fixture test) ABOVE the
    isolation drills — those tear down the global runtime."""
    from ray_tpu_torch.core.api import _global_client

    client = _global_client()
    # warm the lease, then the reply meta lands in local_metas and
    # becomes shippable; the first submit may ride the cold head path
    metas = []
    deadline = time.time() + 30
    while time.time() < deadline and not metas:
        ref = _make_block_probe.remote(600, 9)
        ray_tpu_torch.get(ref, timeout=60)
        metas = client._dep_metas([ref.id.binary()])
    assert metas and metas[0].object_id == ref.id
    assert metas[0].kind in ("shm", "arena", "spilled")
    # inline results never ship (they ride the control plane whole)
    small = ray_tpu_torch.put(b"tiny")
    assert client._dep_metas([small.id.binary()]) == []


@ray_tpu_torch.remote
def _make_block(rows, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((rows, 64))}


@ray_tpu_torch.remote
class _AuditedConsumer:
    """Pipeline-consumer stand-in that audits ITS OWN process's head
    RPCs around the inter-stage block fetch (the handoff happens in the
    worker, where the driver's interposer can't see)."""

    def __init__(self):
        self._events = []
        self._hook = None

    def warm(self, oid_bin, timeout=20.0):
        from ray_tpu_torch.core.api import _global_client
        from ray_tpu_torch.core.ids import ObjectID

        client = _global_client()
        oid = ObjectID(oid_bin)
        deadline = time.time() + timeout
        while time.time() < deadline:
            locs = client.object_dir.locations(oid)
            if locs and any(client.cluster_view.data_addr_of(h)
                            for h in locs):
                return True
            time.sleep(0.05)
        return False

    def audit_start(self):
        from ray_tpu_torch.core import protocol as _p

        events = self._events

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        self._hook = hook
        _p.add_rpc_interposer(hook)
        return True

    def consume(self, wrapped):
        # the ref rides NESTED so resolution happens inside the audit
        # window (a top-level arg would resolve before the method body)
        ref = wrapped[0]
        block = ray_tpu_torch.get(ref, timeout=60)
        return float(np.asarray(block["x"]).sum())

    def audit_stop(self):
        from ray_tpu_torch.core import protocol as _p

        if self._hook is not None:
            _p.remove_rpc_interposer(self._hook)
            self._hook = None
        out, self._events = self._events, []
        return out


@pytest.mark.chaos
def test_warm_inter_stage_handoff_zero_head_rpcs():
    """A warm inter-stage block handoff — producer on node A,
    consumer on node B, directory gossip settled — makes ZERO head round
    trips in the consumer (meta from the gossiped directory, bytes
    through the node PullManager)."""
    c, _ = _iso_cluster()
    try:
        ref = _make_block.options(resources={"nodeA": 1}).remote(800, 3)
        ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
        consumer = _AuditedConsumer.options(resources={"nodeB": 1}).remote()
        assert ray_tpu_torch.get(consumer.warm.remote(ref.id.binary()),
                           timeout=60), "consumer directory never warmed"
        assert ray_tpu_torch.get(consumer.audit_start.remote(), timeout=30)
        total = ray_tpu_torch.get(consumer.consume.remote([ref]), timeout=60)
        events = ray_tpu_torch.get(consumer.audit_stop.remote(), timeout=30)
        expect = float(np.random.default_rng(3).random((800, 64)).sum())
        assert abs(total - expect) < 1e-6
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"warm handoff made head round trips: {reqs}"
        pushes = {m for k, m in events if k == "push"}
        # blocked/unblocked worker-state reporting is push telemetry
        # like ref transitions — not a round trip
        assert pushes <= {"ref_update", "metrics_push", "blocked"}, pushes
    finally:
        _iso_teardown(c)


# ------------------------------------------------- chaos drill: shuffle
@pytest.mark.chaos
def test_shuffle_survives_node_sigkill_mid_shuffle():
    """SIGKILL the node holding every map
    sub-block after the map stage lands but before reduce consumes.
    Lineage reconstruction re-runs exactly the lost map tasks, the
    shuffle completes byte-identical to the no-chaos run, and
    data_blocks_reconstructed_total counts exactly the lost
    partitions."""
    c, nids = _iso_cluster()
    extra = None
    try:
        P = 4
        rng = np.random.default_rng(0)
        blocks = []
        for i in range(4):
            # ~832 KB per partition → ~208 KB per sub-block (> the
            # 100 KiB inline threshold, so sub-blocks live in node shm
            # and genuinely die with the node)
            blocks.append({
                "k": np.arange(1600, dtype=np.int64) + 1600 * i,
                "x": rng.random((1600, 64))})
        # no-chaos reference, computed in-process with the same fns
        parts = [shf._map_partition(b, [], P, "hash", "k", None, None)
                 for b in blocks]
        expected = [shf._reduce_concat(*[pp[p] for pp in parts])
                    for p in range(P)]

        map_task = ray_tpu_torch.remote(shf._map_partition).options(
            num_returns=P, name="data_shuffle_map", data_stage=True,
            resources={"nodeA": 1})
        reducer = ray_tpu_torch.remote(shf._reduce_concat).options(
            name="data_shuffle_reduce", lineage=True, data_stage=True,
            resources={"nodeB": 1})

        refs = [map_task.remote(b, [], P, "hash", "k", None, None)
                for b in blocks]
        flat = [r for rs in refs for r in rs]
        ready, _ = ray_tpu_torch.wait(flat, num_returns=len(flat), timeout=120)
        assert len(ready) == len(flat), "map stage never completed"
        pre_recon = _head_stat("data_reconstructs")

        # SIGKILL the node holding every sub-block, mid-shuffle
        c.kill_node(nids[0])
        time.sleep(1.0)
        # reconstruction needs somewhere with the map stage's resources
        extra = c.add_node(num_cpus=2, resources={"nodeA": 4})
        c.wait_for_nodes(3)

        out = [reducer.remote(*[refs[m][p] for m in range(len(blocks))])
               for p in range(P)]
        got = ray_tpu_torch.get(out, timeout=240)

        # byte-identical to the no-chaos run
        for g, e in zip(got, expected):
            assert set(g) == set(e)
            for col in e:
                assert np.array_equal(np.asarray(g[col]),
                                      np.asarray(e[col])), col

        # exactly the lost partitions were rebuilt: every one of the
        # 4x4 sub-blocks was primary on the killed node
        deadline = time.time() + 20
        recon = 0
        while time.time() < deadline:
            recon = _head_stat("data_reconstructs") - pre_recon
            if recon >= len(blocks) * P:
                break
            time.sleep(0.2)
        assert recon == len(blocks) * P, (
            f"expected {len(blocks) * P} reconstructed sub-blocks, "
            f"saw {recon}")
        # and only the map tasks re-executed (one lazy reconstruction
        # per lost producer; completed reducers never re-run)
        from ray_tpu_torch.util import state

        events = [e for e in state.list_lease_events()
                  if e.get("kind") == "object_reconstruct"]
        assert len(events) == len(blocks), events
        assert all(e.get("task") == "data_shuffle_map" for e in events)
        assert all(e.get("data_stage") for e in events)
    finally:
        _iso_teardown(c)


# --------------------------------------- interest-on-demand view widening
@pytest.mark.chaos
def test_interest_widening_stops_locate_fallbacks():
    """A scoped daemon that cold-misses a data-plane pull
    into locate_object widens its shard subscription to the serving
    node's shard — the NEXT object from that neighborhood resolves from
    the gossiped directory with zero additional locate calls
    (fallback-counted at the caller, gossiped to the head)."""
    env = {"RAY_TPU_VIEW_SHARDS": "4"}
    node_kw = [{"num_cpus": 1, "resources": {f"n{i}": 4}} for i in range(4)]
    c, nids = _iso_cluster(extra_env=env, nodes=4, node_kw=node_kw)
    try:
        from ray_tpu_torch.core.api import _global_client
        from ray_tpu_torch.core.resource_view import shard_of

        # pick a producer/consumer pair in DIFFERENT shards
        shards = [shard_of(h, 4) for h in nids]
        pair = None
        for i in range(4):
            for j in range(4):
                if shards[i] != shards[j]:
                    pair = (i, j)
                    break
            if pair:
                break
        if pair is None:
            pytest.skip("all nodes hashed into one shard")
        prod, cons = pair
        client = _global_client()

        def make_on(seed):
            ref = _make_block.options(
                resources={f"n{prod}": 1}).remote(700, seed)
            ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
            deadline = time.time() + 20
            while time.time() < deadline:
                meta = (client.local_metas.get(ref.id)
                        or client.object_dir.lookup_meta(ref.id))
                if meta is not None and meta.kind in ("shm", "arena"):
                    return ref, meta
                time.sleep(0.05)
            raise AssertionError("producer meta never resolved")

        def consumer_daemon_pull(meta):
            addr = None
            deadline = time.time() + 20
            while time.time() < deadline:
                addr = client.cluster_view.data_addr_of(nids[cons])
                if addr:
                    break
                time.sleep(0.05)
            assert addr, "consumer node data addr unknown"
            local = client.direct_request(tuple(addr), "pull_object",
                                          meta=meta, sources=None)
            assert local is not None

        def fallbacks():
            deadline = time.time() + 20
            while time.time() < deadline:
                v = _node_stat(nids[cons], "locate_fallbacks")
                if v is not None:
                    return v
                time.sleep(0.2)
            return None

        ref1, meta1 = make_on(21)
        consumer_daemon_pull(meta1)

        # first cold pull paid the fallback and triggered widening
        deadline = time.time() + 25
        first = 0
        while time.time() < deadline:
            first = fallbacks() or 0
            if first >= 1:
                break
            time.sleep(0.3)
        assert first >= 1, "cold pull never hit the locate fallback"
        from ray_tpu_torch.util import state

        deadline = time.time() + 25
        widened = []
        while time.time() < deadline:
            widened = [e for e in state.list_lease_events()
                       if e.get("kind") == "interest_widen"
                       and e.get("node_id") == nids[cons]]
            if widened:
                break
            time.sleep(0.3)
        assert widened, "daemon never widened its shard interest"

        # a NEW object in the same (now-covered) shard: give the scoped
        # delta a broadcast tick, then the pull must resolve from the
        # widened directory — fallback count unchanged
        ref2, meta2 = make_on(22)
        time.sleep(1.5)
        consumer_daemon_pull(meta2)
        time.sleep(2.5)   # let the stats gossip land
        assert fallbacks() == first, (
            "repeated data-plane pull still paid the locate fallback "
            "after interest widening")
    finally:
        _iso_teardown(c, extra_env=env)


# --------------------------------------- continuous-ingest elastic drill
def _ingest_loop(config):
    """Each rank records its slice of every global batch; rank 0
    checkpoints the next batch's index under `config["ckpt_root"]`. The
    controller commits a checkpoint of step i only once every rank has
    reported step i, so the resumed run never skips a peer's half of a
    batch."""
    import json as _json
    import os as _os
    import tempfile
    import time as _time

    import numpy as _np

    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    shard = train.get_dataset_shard("train")
    world, rank = ctx.get_world_size(), ctx.get_world_rank()
    gen = ctx.get_generation()
    ck = ctx.get_checkpoint()
    start = 0
    if ck is not None:
        with open(_os.path.join(ck.path, "state.json")) as f:
            start = _json.load(f)["next"]
    for gi, batch in shard.iter_global_batches(
            batch_size=config["batch"], start_batch=start):
        if gi >= config["steps"]:
            break
        part = int(_np.asarray(batch["id"], dtype=_np.int64).sum())
        ckpt = None
        if rank == 0:
            d = tempfile.mkdtemp(prefix="ingest_ckpt_",
                                 dir=config["ckpt_root"])
            with open(_os.path.join(d, "state.json"), "w") as f:
                _json.dump({"next": gi + 1}, f)
            ckpt = Checkpoint(d)
        with open(config["history"], "a") as f:
            f.write(_json.dumps({"gen": gen, "world": world, "rank": rank,
                                 "step": gi, "sum": part}) + "\n")
        train.report({"step": gi, "world": world}, checkpoint=ckpt)
        _time.sleep(config.get("step_s", 0.05))


def _read_history(path):
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


@pytest.mark.chaos
def test_continuous_ingest_rides_elastic_resize(tmp_path):
    """Data → trainer with the elastic controller
    resizing mid-stream (node SIGKILL shrinks 2 → 1). Batch identity is
    the GLOBAL index, so across the resize every global batch is
    consumed exactly once by its final owning generation — no
    duplicates, no drops, contents identical to the no-chaos stream."""
    from ray_tpu_torch.train import (ElasticConfig, FailureConfig,
                                     RunConfig, ScalingConfig)
    from ray_tpu_torch.train.controller import TrainControllerLogic

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cluster = Cluster(num_cpus=0)
    # 2 CPUs per node: one for the gang worker, one of headroom for the
    # pipeline's nested data tasks (a starved pipeline is a hang, not a
    # drill); SPREAD places one gang worker per node so the kill is a
    # genuine shrink
    nids = [cluster.add_node(num_cpus=2), cluster.add_node(num_cpus=2)]
    cluster.connect()
    cluster.wait_for_nodes(3)
    history = str(tmp_path / "history.jsonl")
    steps, batch = 12, 8
    ds = rdata.range(steps * batch, parallelism=4)
    try:
        logic = TrainControllerLogic(
            _ingest_loop,
            {"steps": steps, "batch": batch, "history": history,
             "step_s": 0.25, "ckpt_root": str(tmp_path)},
            ScalingConfig(num_workers=2, min_workers=1, use_gpu=False,
                          resources_per_worker={"CPU": 1},
                          placement_strategy="SPREAD",
                          elastic=ElasticConfig(regrow=False,
                                                schedule_wait_s=30.0)),
            RunConfig(name="ingest", storage_path=str(tmp_path),
                      failure_config=FailureConfig(max_failures=3)),
            datasets={"train": ds})
        box = {}

        def run():
            try:
                box["result"] = logic.run()
            except BaseException as e:
                box["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.time() + 180
        while time.time() < deadline:
            if any(e["world"] == 2 and e["step"] >= 3
                   for e in _read_history(history)):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("2-worker ingest never progressed")
        cluster.kill_node(nids[1])
        t.join(timeout=240)
        assert not t.is_alive(), "controller never finished after kill"
        assert "error" not in box, box.get("error")
        result = box["result"]
        assert result["state"] == "FINISHED", result["error"]
        assert result["restarts"] >= 1
        assert result["final_world_size"] == 1

        entries = _read_history(history)
        # effective stream = per step, the FINAL generation that
        # consumed it; rank sums of that generation must reconstruct
        # the global batch exactly
        by_step = {}
        for e in entries:
            by_step.setdefault(e["step"], []).append(e)
        assert set(by_step) == set(range(steps)), sorted(by_step)
        for step, rows in by_step.items():
            final_gen = max(r["gen"] for r in rows)
            owners = [r for r in rows if r["gen"] == final_gen]
            # no duplicates inside the owning generation
            assert len({r["rank"] for r in owners}) == len(owners), owners
            got = sum(r["sum"] for r in owners)
            lo = step * batch
            expect = sum(range(lo, lo + batch))
            assert got == expect, (step, got, expect, owners)
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        cluster.shutdown()
    assert cluster.processes() == [] and cluster.segments() == []
