"""Headless resilience: daemon-to-daemon task spillback drills.

The port's mirror of `tests/test_peer_spillback.py`'s four drills,
against `ray_tpu_torch`; each drill's cluster must leave no process and
no `rtpt_*` segment of its session behind.

The PR-11 tentpole contracts, driven through the chaos plane:

- with the head SIGSTOPped mid-burst, a 2-node cluster keeps completing
  COLD-path tasks: local-pool misses are referred to peer daemons whose
  gossiped pools show warm workers (epoch-stamped peer grants), the
  client's parked dispatch queues drain through those leases, and the
  interposer proves the audited window made ZERO head round trips;
- on SIGCONT the pool ledgers reconcile with zero double-grants;
- a partitioned peer mid-spill fails over (next candidate / head)
  instead of hanging or double-granting;
- a driver `get()` of a directory-cached object completes while the
  head is unreachable (the cold-miss `locate_object` fallback must not
  block a warm-cache hit behind a head retry loop);
- with the head SIGKILLed (not just paused), cold-path tasks still
  complete through daemon-local grants + parked dispatch, and the
  restarted head reconciles from daemon truth.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import protocol

pytestmark = pytest.mark.chaos


def _assert_clean(cluster):
    assert cluster.processes() == [], cluster.processes()
    assert cluster.segments() == [], cluster.segments()


def _client():
    from ray_tpu_torch.core.api import _global_client

    return _global_client()


def _overrides(extra=None):
    ov = {"RAY_TPU_LEASE_IDLE_S": "0.5",
          "RAY_TPU_POOL_IDLE_S": "60",
          "RAY_TPU_POOL_ACQUIRE_TIMEOUT_S": "2",
          "RAY_TPU_METRICS_PUSH_INTERVAL_S": "0.5"}
    ov.update(extra or {})
    saved = {k: os.environ.get(k) for k in ov}
    os.environ.update(ov)
    return saved


def _restore(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(what() if callable(what) else what)


def _daemon_rows(client):
    rows = client.head_request("list_state", kind="scheduler_stats")
    return [r for r in rows if not r.get("is_head")]


def _wait_idle_pools(client, per_node, nodes=2, timeout=60):
    def ready():
        idles = [e.get("idle_workers", 0)
                 for e in client.cluster_view.entries.values()
                 if e.get("sched_addr")]
        return (len(idles) >= nodes
                and sum(1 for i in idles if i >= per_node) >= nodes
                and not client._leases)

    def msg():
        pools = [(e["node_id"][:8], e.get("idle_workers"))
                 for e in client.cluster_view.entries.values()]
        return f"pools never warmed to {per_node}/node: {pools}"

    _wait(ready, timeout, msg)


@ray_tpu_torch.remote
def _g0(x):
    return ("g0", x * 2, os.getpid())


@ray_tpu_torch.remote
def _g1(x):
    return ("g1", x * 3, os.getpid())


@ray_tpu_torch.remote
def _g2(x):
    return ("g2", x * 5, os.getpid())


@ray_tpu_torch.remote
def _g3(x):
    return ("g3", x * 7, os.getpid())


_FNS = [_g0, _g1, _g2, _g3]
_MULT = {"g0": 2, "g1": 3, "g2": 5, "g3": 7}


def _carve_pool(client, sched_addr, n, timeout=90, selector=None):
    from ray_tpu_torch.cluster_utils import carve_pool

    carve_pool(client, sched_addr, n, timeout=timeout, selector=selector)


def _warm_both_pools(client, per_node=2):
    """Carve `per_node` workers into each daemon's pool (direct
    scheduler leases, returned immediately; the zone selector pins the
    carve to that node so it cannot turn into a peer referral);
    pool_idle_s is long in these drills, so the pools stay warm through
    the outage windows."""
    entries = [e for e in client.cluster_view.entries.values()
               if e.get("sched_addr")]
    assert len(entries) >= 2, entries
    for e in entries:
        _carve_pool(client, tuple(e["sched_addr"]), per_node,
                    selector={"zone": e["labels"]["zone"]})
    _wait_idle_pools(client, per_node=per_node)


def test_head_paused_burst_completes_via_peer_spillback():
    """ACCEPTANCE DRILL: SIGSTOP the head mid-burst on a 2-node cluster.
    Cold-path tasks must keep completing through the peer mesh — local
    grants where the picked daemon's pool is warm, peer-referred grants
    where it missed — with ZERO head round trips in the audited window,
    and the pool ledgers must reconcile on SIGCONT with no double
    grants."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import state

    saved = _overrides()
    cluster = Cluster(num_cpus=0)  # the head schedules nothing itself
    cluster.add_node(num_cpus=2, labels={"zone": "a"})
    cluster.add_node(num_cpus=2, labels={"zone": "b"})
    paused = False
    try:
        cluster.connect()
        cluster.wait_for_nodes(3)
        client = _client()
        _wait(lambda: sum(1 for e in client.cluster_view.entries.values()
                          if e.get("sched_addr")) >= 2, 30,
              "view never advertised both daemon schedulers")

        # warm phase: zone-pinned shapes carve two workers per node; the
        # long pool_idle_s keeps the pools warm through the outage. The
        # _g* burst shapes have NEVER been submitted — they are genuinely
        # cold (their definitions ride the parked specs).
        _warm_both_pools(client)
        pre_rows = _daemon_rows(client)
        pre_acquires = sum(r.get("pool_acquires", 0) for r in pre_rows)

        # ---- outage window -------------------------------------------
        cluster.stop_head()
        paused = True
        # suspicion latched (in production the acquire-timeout path arms
        # this; latching it directly keeps the drill inside the tier-1
        # budget instead of waiting out a 15s probe)
        client._head_suspect_until = time.monotonic() + 120

        events = []

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        protocol.add_rpc_interposer(hook)
        try:
            refs = [fn.remote(j) for j in range(10) for fn in _FNS]
            out = ray_tpu_torch.get(refs, timeout=90)
        finally:
            protocol.remove_rpc_interposer(hook)
        for j, (name, val, _pid) in zip(
                [j for j in range(10) for _ in _FNS], out):
            assert val == j * _MULT[name]
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"outage-window burst made head round trips: {reqs}"
        pushes = {m for k, m in events if k == "push"}
        assert "submit_task" not in pushes, \
            "cold-path tasks rode the (paused) head queue"
        # permitted: background telemetry + the DEFERRED fn exports (a
        # fire-and-forget push buffered until resume; the specs carried
        # the definitions, so nothing waited on it)
        assert pushes <= {"ref_update", "metrics_push", "kv_put"}, pushes
        assert client.lease_stats["peer_grants"] >= 1, client.lease_stats
        # grants spread over distinct workers (a double grant would fold
        # shapes onto one worker): judge by the pids that actually ran
        # the burst
        pids = {pid for _name, _val, pid in out}
        assert len(pids) >= 2, f"burst ran on a single worker: {pids}"

        # ---- resume + reconciliation ---------------------------------
        cluster.cont_head()
        paused = False
        client._head_suspect_until = 0.0

        def reconciled():
            rows = _daemon_rows(client)
            if len(rows) < 2:
                return False
            for r in rows:
                if not r.get("alive"):
                    return False
                # head-side carve-out ledger == daemon-gossiped pool
                if r.get("pooled_workers") != (r.get("idle_workers", 0)
                                               + r.get("leased_workers", 0)):
                    return False
            # the outage-window peer traffic reached the head's merged
            # telemetry (counters ride the queued gossip, which drains
            # after SIGCONT — wait for it rather than racing it)
            return (sum(r.get("peer_spillbacks", 0) for r in rows) >= 1
                    and sum(r.get("peer_grants", 0) for r in rows) >= 1)

        _wait(reconciled, 60,
              lambda: f"ledgers/counters never reconciled: "
                      f"{_daemon_rows(client)}")
        rows = _daemon_rows(client)
        # the outage made the head carve nothing (peer mesh served it)
        assert sum(r.get("pool_acquires", 0) for r in rows) \
            == pre_acquires, (pre_acquires, rows)
        head_row = next(r for r in client.head_request(
            "list_state", kind="scheduler_stats") if r.get("is_head"))
        assert head_row.get("stale_epoch_rejects", 0) == 0, head_row
        # peer-grant lease events reached the head via gossip
        kinds = {e["kind"] for e in state.list_lease_events()}
        assert "peer_grant" in kinds and "peer_spill" in kinds, kinds
        # the plane still schedules after the outage
        assert ray_tpu_torch.get(_g0.remote(21), timeout=60)[1] == 42
    finally:
        if paused:
            cluster.cont_head()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        _restore(saved)


def test_peer_partition_mid_spill_fails_over():
    """Sever the client→peer scheduler edge exactly when a referral
    lands: the grant attempt must fail over (here: to the live head)
    instead of hanging, and the healed mesh must grant via the peer
    afterwards."""
    from ray_tpu_torch.cluster_utils import Cluster

    saved = _overrides()
    cluster = Cluster(num_cpus=0)
    # A is registered first, so on a warm-pool tie the client routes to
    # it; the zone labels let the drain sleepers pin deterministically
    nid_a = cluster.add_node(num_cpus=2, labels={"zone": "a"})
    cluster.add_node(num_cpus=2, labels={"zone": "b"})
    try:
        cluster.connect()
        cluster.wait_for_nodes(3)
        client = _client()
        _wait(lambda: sum(1 for e in client.cluster_view.entries.values()
                          if e.get("sched_addr")) >= 2, 30,
              "view never advertised both daemon schedulers")

        # warm both pools, then let the leases lapse
        _warm_both_pools(client)

        # freeze A's OUTBOUND gossip so its view entry stays stale-warm
        # (it still receives broadcasts, so its referral candidates are
        # live), then drain its pool with zone-pinned sleeper leases:
        # the next cold shape routed to A MUST take the referral path
        assert client.head_request(
            "set_node_chaos", node_id=bytes.fromhex(nid_a),
            spec="drop:resource_view_delta@node:p=1.0") is True

        @ray_tpu_torch.remote(label_selector={"zone": "a"})
        def nap_a1(s):
            time.sleep(s)
            return os.getpid()

        @ray_tpu_torch.remote(label_selector={"zone": "a"})
        def nap_a2(s):
            time.sleep(s)
            return os.getpid()

        sleepers = [nap_a1.remote(10), nap_a2.remote(10)]
        time.sleep(1.0)  # both zone-a leases taken from A's pool
        # sever the client→REFERRED-PEER edge (B's scheduler) from this
        # driver only: A's referral names B's sched addr, and the grant
        # attempt there must fail over, not hang
        addr_b = next(tuple(e["sched_addr"])
                      for e in client.cluster_view.entries.values()
                      if e.get("sched_addr") and e["node_id"] != nid_a)
        protocol.configure_chaos(f"partition:sched-{addr_b[1]}:for=8")
        head_asks = []

        def hook(conn_name, kind, method):
            if conn_name == "head" and method == "acquire_lease":
                head_asks.append(kind)

        protocol.add_rpc_interposer(hook)
        try:
            # A's frozen entry still advertises warm workers, so the
            # client routes here; A's pool is drained ⇒ referral to B ⇒
            # the partition bites ⇒ failover (to the live head) must
            # complete the task promptly
            t0 = time.time()
            assert ray_tpu_torch.get(_g0.remote(5), timeout=60)[1] == 10
            assert time.time() - t0 < 30, "failover stalled"
        finally:
            protocol.remove_rpc_interposer(hook)
            protocol.configure_chaos("")
        # the failover asked the live head. The reference's head grants
        # that lease at once on a node whose CPUs the pools and sleepers
        # hold (its ledger reads CPU -1.0 there: head_grants 1); the
        # port's head grants only what its ledger covers, so the ask
        # waits and the task runs as capacity frees (head_grants 0)
        assert "req" in head_asks, head_asks
        from ray_tpu_torch.util import state

        assert all(v >= 0 for n in state.list_nodes()
                   for v in n["available"].values()), state.list_nodes()
        assert client.lease_stats["peer_grants"] == 0, client.lease_stats
        ray_tpu_torch.get(sleepers, timeout=60)
        # heal A's gossip; its peer_spill record reaches the head, and
        # the plane keeps scheduling
        assert client.head_request(
            "set_node_chaos", node_id=bytes.fromhex(nid_a),
            spec="") is True
        assert ray_tpu_torch.get(_g1.remote(4), timeout=60)[1] == 12

        def a_recorded_spill():
            rows = _daemon_rows(client)
            row = next((r for r in rows if r["node_id"] == nid_a), None)
            return row is not None and row.get("peer_spillbacks", 0) >= 1

        _wait(a_recorded_spill, 30,
              lambda: f"A never recorded the spill: {_daemon_rows(client)}")
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        _restore(saved)


def test_directory_cached_get_completes_while_head_paused():
    """Satellite: a driver-side get() of a directory-cached object must
    complete while the head is unreachable — the cold-miss
    locate_object fallback cannot block a warm-cache hit behind a head
    retry loop. Store isolation forces a real cross-node pull."""
    import numpy as np

    from ray_tpu_torch.cluster_utils import Cluster

    saved = _overrides({"RAY_TPU_STORE_ISOLATION": "1"})
    cluster = Cluster(num_cpus=0)
    cluster.add_node(num_cpus=2, resources={"src": 2})
    paused = False
    try:
        cluster.connect()
        cluster.wait_for_nodes(2)
        client = _client()

        @ray_tpu_torch.remote(resources={"src": 1})
        def make(n):
            return np.arange(n, dtype=np.int64)

        ref = make.remote(200_000)  # ~1.6 MB: never inline
        # wait until the gossiped directory can resolve it AND the view
        # knows the serving node's data server — the warm-cache state
        _wait(lambda: (client.object_dir.lookup_meta(ref.id) is not None
                       and client._sources_from_view(
                           client.object_dir.lookup_meta(ref.id))),
              60, "directory/view never learned the object")

        cluster.stop_head()
        paused = True
        client._head_suspect_until = time.monotonic() + 120
        events = []

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        protocol.add_rpc_interposer(hook)
        try:
            t0 = time.time()
            arr = ray_tpu_torch.get(ref, timeout=60)
            elapsed = time.time() - t0
        finally:
            protocol.remove_rpc_interposer(hook)
        assert arr.shape == (200_000,) and int(arr[-1]) == 199_999
        assert elapsed < 30, f"warm-cache get stalled {elapsed:.1f}s"
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"directory-cached get made head RPCs: {reqs}"

        cluster.cont_head()
        paused = False
        client._head_suspect_until = 0.0
        assert ray_tpu_torch.get(make.remote(10), timeout=60).shape == (10,)
    finally:
        if paused:
            cluster.cont_head()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        _restore(saved)


def test_cold_tasks_complete_while_head_dead_then_reconcile():
    """Hard-outage variant: SIGKILL the head (no restart yet). A fresh
    cold shape must still complete — parked dispatch + daemon-local
    grant from the surviving pool, with the function definition riding
    the spec (the worker cannot fetch it from the dead head's KV). The
    restarted head then reconciles from daemon truth."""
    from ray_tpu_torch.cluster_utils import Cluster

    saved = _overrides({"RAY_TPU_RECONNECT_TIMEOUT_S": "60"})
    cluster = Cluster(num_cpus=0, enable_snapshots=True)
    cluster.add_node(num_cpus=2)
    try:
        cluster.connect()
        cluster.wait_for_nodes(2)
        client = _client()
        _wait(lambda: any(e.get("sched_addr")
                          for e in client.cluster_view.entries.values()),
              30, "view never advertised the daemon scheduler")
        # run the to-be-warm shapes once (plain head-era path), then
        # carve the daemon pool directly so it holds both workers
        ray_tpu_torch.get([_g0.remote(1), _g1.remote(1)], timeout=90)
        addr = next(tuple(e["sched_addr"])
                    for e in client.cluster_view.entries.values()
                    if e.get("sched_addr"))
        _carve_pool(client, addr, 2)
        _wait_idle_pools(client, per_node=2, nodes=1)

        cluster.kill_head()
        _wait(lambda: client._head_suspect(), 30,
              "client never noticed the dead head")
        # _g2/_g3 never ran anywhere: truly cold shapes. They must park,
        # acquire daemon-local leases from the surviving pool, and run
        # with the fn definition shipped in the spec.
        t0 = time.time()
        out = ray_tpu_torch.get([_g2.remote(4), _g3.remote(4)], timeout=45)
        headless_s = time.time() - t0
        assert [o[1] for o in out] == [20, 28]
        assert headless_s < 40, headless_s

        cluster.restart_head()
        _wait(lambda: not client._head_suspect(), 90,
              "client never reconnected to the restarted head")

        def reconciled():
            try:
                rows = _daemon_rows(client)
            except Exception:
                return False
            return bool(rows) and all(r.get("reconciled") for r in rows)

        _wait(reconciled, 60, "restarted head never reconciled")
        assert ray_tpu_torch.get(_g2.remote(6), timeout=60)[1] == 30
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        _assert_clean(cluster)
        _restore(saved)
