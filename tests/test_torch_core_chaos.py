"""Chaos drills that need node daemons.

The port's mirror of `tests/test_chaos.py`'s cases on daemons, against
`ray_tpu_torch`: the flight recorder across a daemon's freeze and death,
the warm lease path making zero head round trips, an actor restarted
under repeated kills, a pull that survives its owner's freeze, and a
daemon partitioned from the head. The single-node cases of the reference
(its `init()` cluster) run here on a head with no CPUs and one daemon.
Every cluster must leave no process and no `rtpt_*` segment of its
session behind.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import protocol


def _assert_clean(c):
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_cpus=0)
    try:
        c.add_node(num_cpus=4)
        c.connect()
        c.wait_for_nodes(2)
        yield c
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    _assert_clean(c)


def test_flight_recorder_warm_burst_and_daemon_death():
    """Flight recorder on a real 2-node cluster, one spin-up for three
    contracts: (a) a warm daemon-granted burst makes ZERO head round
    trips with instrumentation enabled, yet its local-grant events/
    counters still reach the head (they ride the existing gossip);
    (b) freezing the daemon makes the head's cluster_view_staleness_s
    for that node rise (gossip heartbeat stops); (c) killing it expires
    the node's and its workers' _metrics KV snapshots."""
    import signal

    from ray_tpu_torch.core import config as _config
    from ray_tpu_torch.util import state

    # tight intervals keep this multi-phase test inside the tier-1 budget:
    # fast lease idle-out (the head-vs-daemon cold-grant race dance) and a
    # fast telemetry heartbeat (the staleness clock under test). Set BEFORE
    # spawning so head/daemon/workers inherit them.
    overrides = {"RAY_TPU_LEASE_IDLE_S": "0.5",
                 "RAY_TPU_METRICS_PUSH_INTERVAL_S": "0.5"}
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    cluster = Cluster(num_cpus=0)  # head schedules nothing itself
    nid = cluster.add_node(num_cpus=4)
    try:
        cluster.connect()
        cluster.wait_for_nodes(2)
        client = ray_tpu_torch.core.api._global_client()
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                e.get("sched_addr")
                for e in client.cluster_view.entries.values()):
            time.sleep(0.1)

        @ray_tpu_torch.remote
        def square(x):
            return x * x

        @ray_tpu_torch.remote(max_retries=0)
        def worker_ident():
            from ray_tpu_torch.util import metrics as m

            import ray_tpu_torch.core.api as api

            m.Gauge("test_fr_node_worker", "probe").set(1.0)
            m.flush()
            return api._global_client().worker_id.hex(), os.getpid()

        assert ray_tpu_torch.get([square.remote(i) for i in range(10)],
                           timeout=120) == [i * i for i in range(10)]
        # warm a daemon-granted lease (a head-granted one may win the
        # cold race; let it idle out and retry — same dance as
        # test_resource_view.test_daemon_grants_lease_without_head)
        deadline = time.time() + 90
        while (time.time() < deadline
               and client.lease_stats["daemon_grants"] == 0):
            ray_tpu_torch.get(square.remote(2), timeout=60)
            if client.lease_stats["daemon_grants"]:
                break
            if client._leases:
                time.sleep(float(_config.get("lease_idle_s")) + 0.5)
            else:
                time.sleep(0.05)
        assert client.lease_stats["daemon_grants"] >= 1, client.lease_stats

        # (a) warm burst: zero head round trips. With the short lease
        # idle set above the lease can expire between phases, so re-warm
        # and start the burst immediately (an expired lease would route
        # tasks through the head and fail the zero-RPC assertion for the
        # wrong reason)
        deadline = time.time() + 30
        while time.time() < deadline and not client._leases:
            ray_tpu_torch.get(square.remote(0), timeout=30)
        assert client._leases
        events = []

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        protocol.add_rpc_interposer(hook)
        try:
            refs = [square.remote(i) for i in range(25)]
            out = ray_tpu_torch.get(refs, timeout=60)
        finally:
            protocol.remove_rpc_interposer(hook)
        assert out == [i * i for i in range(25)]
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"instrumented warm burst made head RPCs: {reqs}"

        # the daemon's flight-recorder events + counters reach the head
        # via gossip (no new RPCs anywhere to carry them)
        deadline = time.time() + 30
        while time.time() < deadline:
            kinds = {e["kind"] for e in state.list_lease_events()}
            if "local_grant" in kinds:
                break
            time.sleep(0.3)
        assert "local_grant" in kinds, kinds
        row = next(r for r in state.list_scheduler_stats()
                   if r["node_id"] == nid)
        assert row["local_grants"] >= 1, row
        assert row["staleness_s"] < 30, row

        # worker + daemon metrics snapshots are in the KV namespace
        wid, wpid = ray_tpu_torch.get(worker_ident.remote(), timeout=60)
        wkey, nkey = f"proc:{wid}".encode(), f"proc:node-{nid[:12]}".encode()
        deadline = time.time() + 30
        while time.time() < deadline:
            if (client.head_request("kv_get", ns="_metrics", key=wkey)
                    is not None
                    and client.head_request("kv_get", ns="_metrics",
                                            key=nkey) is not None):
                break
            time.sleep(0.3)
        assert client.head_request("kv_get", ns="_metrics",
                                   key=wkey) is not None
        assert client.head_request("kv_get", ns="_metrics",
                                   key=nkey) is not None

        # (b) frozen daemon: heartbeat stops, head-side staleness rises
        cluster.stop_node(nid)
        time.sleep(2.0)  # = 4x the 0.5s heartbeat interval set above
        row = next(r for r in state.list_scheduler_stats()
                   if r["node_id"] == nid)
        assert row["staleness_s"] > 1.0, row

        # (c) killed daemon: its (and its workers') metric keys expire.
        # The daemon's workers survive it and RECONNECT to the live head
        # (head-FT semantics adopt them onto the head node), which would
        # legitimately re-push their snapshots — kill the worker process
        # too so both expiries are observable.
        cluster._nodes[0].send_signal(signal.SIGCONT)
        cluster.kill_node(nid)
        try:
            os.kill(wpid, 9)
        except OSError:
            pass  # already died with its node
        deadline = time.time() + 60
        while time.time() < deadline:
            if (client.head_request("kv_get", ns="_metrics", key=wkey)
                    is None
                    and client.head_request("kv_get", ns="_metrics",
                                            key=nkey) is None):
                break
            time.sleep(0.3)
        assert client.head_request("kv_get", ns="_metrics", key=nkey) \
            is None, "dead daemon's metrics snapshot still scraped"
        assert client.head_request("kv_get", ns="_metrics", key=wkey) \
            is None, "dead node's worker metrics snapshot still scraped"
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@ray_tpu_torch.remote
def _plus1(x):
    return x + 1


def test_warm_lease_path_makes_zero_head_rpcs(cluster):
    """Two-level scheduling contract: once a lease is warm, a task burst
    is dispatched, executed, and resolved with ZERO head round trips —
    proven by counting head-connection traffic through the RPC
    interposition hook, not by inspecting internals. The only permitted
    head-bound traffic is the refcount tracker's background batch flush
    (a push, not a round trip)."""
    client = ray_tpu_torch.core.api._global_client()
    assert ray_tpu_torch.get(_plus1.remote(0), timeout=30) == 1
    deadline = time.time() + 20
    while time.time() < deadline and not client._leases:
        ray_tpu_torch.get(_plus1.remote(0), timeout=30)
    assert client._leases, "lease never established"
    time.sleep(0.3)  # let registration/refcount stragglers flush

    events = []

    def hook(conn_name, kind, method):
        if conn_name == "head":
            events.append((kind, method))

    protocol.add_rpc_interposer(hook)
    try:
        refs = [_plus1.remote(i) for i in range(25)]
        out = ray_tpu_torch.get(refs, timeout=60)
    finally:
        protocol.remove_rpc_interposer(hook)
    assert out == [i + 1 for i in range(25)]
    reqs = [m for k, m in events if k == "req"]
    assert not reqs, f"warm-path burst made head round trips: {reqs}"
    pushes = {m for k, m in events if k == "push"}
    # permitted head-bound traffic is background telemetry only, and only
    # as pushes: the refcount batch flush and the metrics pusher's
    # periodic snapshot (the flight recorder deliberately rides pushes /
    # existing gossip so the warm path stays RPC-free)
    assert pushes <= {"ref_update", "metrics_push"}, \
        f"warm-path burst pushed more than telemetry batches: {pushes}"


def test_actor_restart_under_repeated_kill(cluster):
    @ray_tpu_torch.remote(max_restarts=3)
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote()) == 1
    for round_ in range(2):
        pid = ray_tpu_torch.get(c.pid.remote())
        os.kill(pid, 9)
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                # state resets on restart (no persistence), process is new
                if ray_tpu_torch.get(c.incr.remote(), timeout=10) >= 1 and \
                        ray_tpu_torch.get(c.pid.remote(), timeout=10) != pid:
                    break
            except Exception:
                time.sleep(0.3)
        else:
            pytest.fail(f"actor did not restart after kill round {round_}")
    ray_tpu_torch.kill(c)


def test_object_pull_survives_owner_node_freeze(cluster):
    """A consumer pulling an object whose host node FREEZES (SIGSTOP'd
    store-serving process) must not hang forever: health checks declare
    the process dead and the consumer surfaces a loss/reconstruction
    outcome instead of stalling (reference: pull retry + health manager
    interplay)."""
    import signal
    import numpy as np

    @ray_tpu_torch.remote
    def make_big():
        return np.ones(300_000, np.uint8)   # > inline: lives in the store

    ref = make_big.remote()
    assert ray_tpu_torch.get(ref, timeout=30).sum() == 300_000
    # find the producing worker and freeze it; the object lives in shm so
    # same-machine reads still work — this asserts the CONTROL plane
    # stays responsive around a frozen peer, and the value stays readable
    from ray_tpu_torch.util import state

    workers = [w for w in state.list_workers() if not w["is_driver"]]
    assert workers
    victim = workers[0]["pid"]
    os.kill(victim, signal.SIGSTOP)
    try:
        got = ray_tpu_torch.get(ref, timeout=60)
        assert got.sum() == 300_000
        # the cluster still schedules new work while the peer is frozen
        @ray_tpu_torch.remote
        def alive():
            return "yes"

        assert ray_tpu_torch.get(alive.remote(), timeout=60) == "yes"
    finally:
        try:
            os.kill(victim, signal.SIGCONT)
        except OSError:
            pass


@pytest.mark.chaos
def test_daemon_partition_warm_path_continues_and_gossip_drains():
    """Partition tolerance (tentpole graceful-degradation contract): a
    timed chaos window severs daemon<->head while client<->daemon and
    worker<->head traffic continues. During the window the daemon keeps
    serving warm-path leases (tasks complete), the head's view of the
    node goes stale; after heal the daemon's queued flight-recorder
    events drain (delivery acks requeue un-acked batches) and its
    counters catch up at the head."""
    from ray_tpu_torch.util import state

    overrides = {"RAY_TPU_POOL_IDLE_S": "60",
                 "RAY_TPU_LEASE_IDLE_S": "1.0",
                 "RAY_TPU_METRICS_PUSH_INTERVAL_S": "0.5"}
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    ray_tpu_torch.shutdown()  # detach from any module-fixture cluster first
    cluster = Cluster(num_cpus=0)
    nid = cluster.add_node(num_cpus=4)
    try:
        cluster.connect()
        cluster.wait_for_nodes(2)
        client = ray_tpu_torch.core.api._global_client()
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                e.get("sched_addr")
                for e in client.cluster_view.entries.values()):
            time.sleep(0.1)

        @ray_tpu_torch.remote
        def square(x):
            return x * x

        assert ray_tpu_torch.get([square.remote(i) for i in range(8)],
                           timeout=120) == [i * i for i in range(8)]
        from conftest import warm_daemon_lease

        warm_daemon_lease(client,
                          lambda: ray_tpu_torch.get(square.remote(2), timeout=60))

        def node_row():
            return next(r for r in state.list_scheduler_stats()
                        if r["node_id"] == nid)

        # park the lease back into the daemon pool, so the burst below
        # must RE-GRANT daemon-locally DURING the partition — producing
        # local_grant events inside the severed window
        with client._lease_lock:
            for lease in client._leases.values():
                lease.dead = True
        deadline = time.time() + 30
        while time.time() < deadline and node_row()["idle_workers"] < 1:
            time.sleep(0.3)
        assert node_row()["idle_workers"] >= 1, node_row()
        grants_before = node_row().get("local_grants", 0)

        # sever daemon<->head for 4s via the chaos control plane
        assert client.head_request(
            "set_node_chaos", node_id=bytes.fromhex(nid),
            spec="partition:node:for=4") is True
        time.sleep(0.5)  # inside the window

        # warm path serves THROUGH the partition: the daemon re-grants
        # from its pool with zero daemon<->head traffic possible
        out = ray_tpu_torch.get([square.remote(i) for i in range(20)],
                          timeout=90)
        assert out == [i * i for i in range(20)]

        # the head's gossip view of the node went stale meanwhile
        row = node_row()
        assert row["staleness_s"] > 0.5, row

        # heal: wait past the window, then the queued events drain —
        # the in-window local_grant reaches the head only via the
        # ack-tracked resend (a severed delta cannot drop its batch)
        deadline = time.time() + 60
        caught_up = False
        while time.time() < deadline and not caught_up:
            row = node_row()
            caught_up = (row["staleness_s"] < 1.5
                         and row.get("local_grants", 0) > grants_before)
            if not caught_up:
                time.sleep(0.5)
        assert caught_up, (row, grants_before)
        kinds = {e["kind"] for e in state.list_lease_events()}
        assert "local_grant" in kinds, kinds
        assert "chaos_config" in kinds, kinds
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_get_with_timeout_returns_while_head_paused():
    """`get(timeout=...)` on an object that only the head can locate (a
    task's result still running, its ref handed over inside another
    value) raises GetTimeoutError within its timeout while the head is
    paused (SIGSTOP), instead of waiting on the head's answer for ever."""
    from ray_tpu_torch.core.exceptions import GetTimeoutError

    c = Cluster(num_cpus=0)
    try:
        c.add_node(num_cpus=2)
        c.connect()
        c.wait_for_nodes(2)

        @ray_tpu_torch.remote
        def slow():
            time.sleep(15)
            return 1

        @ray_tpu_torch.remote
        def outer():
            return [slow.remote()]

        inner = ray_tpu_torch.get(outer.remote(), timeout=60)[0]
        c.stop_head()
        try:
            t0 = time.monotonic()
            with pytest.raises(GetTimeoutError):
                ray_tpu_torch.get(inner, timeout=2)
            waited = time.monotonic() - t0
        finally:
            c.cont_head()
        assert waited < 15, waited
        assert ray_tpu_torch.get(inner, timeout=60) == 1
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    _assert_clean(c)
