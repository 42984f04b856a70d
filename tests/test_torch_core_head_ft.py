"""Head (GCS) fault tolerance: snapshot, SIGKILL, restore.

The port's mirror of `tests/test_head_ft.py`'s three tests, against
`ray_tpu_torch`, followed by the head-restart drill of `chip_smoke.py`'s
phase 15 on the CPU: a `num_gpus=1` detached actor on a daemon outlives a
head restart, keeps its process and its state, and its GPU is not granted
twice. The JAX package re-creates that actor from the snapshot while its
process still runs (two instances, the first one's GPU free in the
ledger); the last test pins that.

Mirrors the reference's GCS-FT semantics (Redis-backed tables + GcsActorManager
restart of detached actors): control-plane state survives a head restart;
detached actors are re-created from their stored specs; a fresh driver finds
everything by name.

Partition-tolerant scheduler additions: a head SIGKILLed mid-warm-burst
comes back, node daemons (which kept serving warm leases from their pools
throughout the outage) reconnect and run the pool-reconciliation
handshake, and the rebuilt ledger matches the daemons' reported
carve-outs exactly — no double-grant, no leaked carve-out; stale-epoch
operations are rejected and counted, and retryable tasks submitted
across the outage all complete.
"""

import json
import os
import signal
import subprocess
import sys
import time
import uuid

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import _descendants, _session_pids


def _kill_session(proc, session):
    """The drill's SIGKILL of a head also takes the processes it started
    (a lost head machine), then nothing of the session may be left."""
    children = _descendants(proc.pid)
    proc.kill()
    proc.wait()
    for pid in children + _session_pids(session):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _stop_and_check(proc, session):
    """SIGTERM stops the head through head.stop() (its workers killed,
    its arena unlinked): no process and no segment of the session stay."""
    from ray_tpu_torch.core.store import SHM_PREFIX

    proc.terminate()
    proc.wait(timeout=30)
    deadline = time.monotonic() + 15
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _session_pids(session) == []
    import glob

    assert glob.glob(f"/dev/shm/{SHM_PREFIX}*{session[:8]}*") == []


def _start_head(session: str, restore: bool = False) -> tuple:
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.head_main",
           "--session", session, "--num-cpus", "4", "--num-gpus", "0",
           "--enable-snapshots"]
    if restore:
        cmd.append("--restore")
    from ray_tpu_torch.core.resources import strip_device_env

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=strip_device_env(dict(os.environ)))
    line = proc.stdout.readline()
    assert line.startswith("RAY_TPU_HEAD_PORT="), line
    port = int(line.strip().split("=")[1])
    if restore:
        line = proc.stdout.readline()
        assert line.strip() == "RAY_TPU_RESTORED=1", line
    return proc, port


def test_head_restart_restores_state(tmp_path):
    # unique in its first 8 characters: a session's segments are found
    # by that prefix, and concurrent test processes must not share it
    session = f"ft{uuid.uuid4().hex[:12]}"
    proc, port = _start_head(session)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{port}")

        @ray_tpu_torch.remote(lifetime="detached", name="ft-counter")
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        h = Counter.remote()
        assert ray_tpu_torch.get(h.incr.remote()) == 1
        client = ray_tpu_torch.core.api._global_client()
        client.head_request("kv_put", ns="app", key=b"cfg",
                            value=b"persisted", overwrite=True)
        # wait for a snapshot cycle to capture the state
        time.sleep(3.0)
        ray_tpu_torch.shutdown()
    finally:
        _kill_session(proc, session)

    # --- head comes back with --restore
    proc2, port2 = _start_head(session, restore=True)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{port2}")
        client = ray_tpu_torch.core.api._global_client()
        assert client.head_request("kv_get", ns="app", key=b"cfg") == b"persisted"
        # detached actor was re-created from its spec (fresh state: the
        # process died with the old head, like a GCS-driven actor restart)
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                h = ray_tpu_torch.get_actor("ft-counter")
                assert ray_tpu_torch.get(h.incr.remote(), timeout=15) == 1
                break
            except Exception:
                time.sleep(0.5)
        else:
            pytest.fail("detached actor not restored after head restart")
        ray_tpu_torch.shutdown()
    finally:
        _stop_and_check(proc2, session)


def test_head_restart_restores_pg_bound_actor():
    """Regression: restored detached actors bound to a placement group need
    the PG re-created first, or scheduling marks them DEAD."""
    session = f"fp{uuid.uuid4().hex[:12]}"
    proc, port = _start_head(session)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{port}")
        from ray_tpu_torch.core.placement_group import placement_group

        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)

        @ray_tpu_torch.remote(lifetime="detached", name="ft-pg-actor",
                        num_cpus=1, placement_group=pg)
        class Svc:
            def ping(self):
                return "pong"

        h = Svc.remote()
        assert ray_tpu_torch.get(h.ping.remote(), timeout=30) == "pong"
        time.sleep(3.0)  # snapshot cycle
        ray_tpu_torch.shutdown()
    finally:
        _kill_session(proc, session)

    proc2, port2 = _start_head(session, restore=True)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{port2}")
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                h = ray_tpu_torch.get_actor("ft-pg-actor")
                assert ray_tpu_torch.get(h.ping.remote(), timeout=15) == "pong"
                break
            except Exception:
                time.sleep(0.5)
        else:
            pytest.fail("PG-bound detached actor not restored")
        ray_tpu_torch.shutdown()
    finally:
        _stop_and_check(proc2, session)


@pytest.mark.chaos
def test_head_restart_reconciles_daemon_pools_no_double_grant():
    """The partition-tolerance acceptance drill: kill the head
    mid-warm-burst, restart it on the same port, and assert that after
    the reconciliation handshake (1) the head ledger's granted capacity
    equals the union of daemon-reported carve-outs — no double-grant, no
    leaked carve-out; (2) the cluster epoch advanced and stale-epoch RPCs
    are rejected-and-counted rather than applied; (3) retryable tasks
    submitted before, during, and after the outage all complete."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import state

    overrides = {
        # the daemon pool must outlive the restart window...
        "RAY_TPU_POOL_IDLE_S": "60",
        # ...while the driver lease cycles fast (returns workers to the
        # daemon pool, so the pool holds idle carve-outs to reconcile)
        "RAY_TPU_LEASE_IDLE_S": "0.5",
        "RAY_TPU_METRICS_PUSH_INTERVAL_S": "0.5",
    }
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    cluster = Cluster(num_cpus=0, enable_snapshots=True)
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
                          lambda: ray_tpu_torch.get(square.remote(2), timeout=60),
                          idle_wait=1.0)

        def node_row():
            return next(r for r in state.list_scheduler_stats()
                        if r["node_id"] == nid)

        # the daemon holds at least one carve-out (leased or idle)
        deadline = time.time() + 30
        while time.time() < deadline and node_row()["pooled_workers"] == 0:
            time.sleep(0.2)
        row = node_row()
        assert row["pooled_workers"] >= 1, row
        epoch0 = next(r for r in state.list_scheduler_stats()
                      if r.get("is_head"))["epoch"]
        assert epoch0 > 0
        pooled_wid = next(
            w["worker_id"] for w in state.list_workers()
            if not w["is_driver"] and w["node_id"] == nid)

        # in-flight burst across the kill; retryable (default max_retries)
        refs = [square.remote(i) for i in range(16)]
        cluster.kill_head()
        # submissions during the outage: the warm lease keeps serving;
        # anything that needs the head queues client-side for replay
        refs += [square.remote(i) for i in range(16, 24)]
        cluster.restart_head(restore=True)

        # wait for the daemon to reconnect and reconcile
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if node_row()["reconciled"]:
                    break
            except (StopIteration, Exception):
                pass
            time.sleep(0.3)
        assert node_row()["reconciled"], node_row()

        # every retryable task submitted across the outage completes
        assert ray_tpu_torch.get(refs, timeout=180) == [i * i for i in range(24)]

        # reconciliation events + epoch bump are visible
        head_row = next(r for r in state.list_scheduler_stats()
                        if r.get("is_head"))
        assert head_row["epoch"] > epoch0, (head_row["epoch"], epoch0)
        assert head_row["reconciles"] >= 1, head_row
        kinds = {e["kind"] for e in state.list_lease_events()}
        assert "pool_reconcile" in kinds, kinds

        # ledger consistency: once the burst drains and the driver lease
        # idles back into the daemon pool, the head's carved capacity
        # must equal the union of daemon-reported carve-outs, and the
        # node ledger must balance exactly (no double-grant, no leak)
        deadline = time.time() + 45
        consistent = False
        while time.time() < deadline and not consistent:
            row = node_row()
            nodes = {n["node_id"]: n for n in state.list_nodes()}
            n = nodes.get(nid)
            if n is not None and row["alive"]:
                carved = (n["resources"].get("CPU", 0)
                          - n["available"].get("CPU", 0))
                busy = sum(1 for w in state.list_workers()
                           if w["node_id"] == nid and w.get("task"))
                consistent = (
                    row["pooled_workers"] == (row["idle_workers"]
                                              + row["leased_workers"])
                    and row["pooled_workers"] >= 1
                    and abs(carved - (row["pooled_workers"] + busy)) < 1e-6)
            if not consistent:
                time.sleep(0.5)
        assert consistent, (node_row(), state.list_nodes())
        assert n["available"].get("CPU", 0) >= 0, n

        # stale-epoch fencing: an op stamped with the dead epoch is
        # rejected (and counted), never applied to the rebuilt ledger
        before = node_row()["pooled_workers"]
        rep = client.head_request("pool_release",
                                  worker_id=bytes.fromhex(pooled_wid),
                                  epoch=epoch0)
        assert isinstance(rep, dict) and rep.get("stale_epoch"), rep
        assert node_row()["pooled_workers"] == before
        head_row = next(r for r in state.list_scheduler_stats()
                        if r.get("is_head"))
        assert head_row["stale_epoch_rejects"] >= 1, head_row
        kinds = {e["kind"] for e in state.list_lease_events()}
        assert "stale_epoch" in kinds, kinds

        # duplicate-release idempotence (epoch + seq keyed): releasing the
        # same worker twice under the CURRENT epoch applies at most once
        cur_epoch = head_row["epoch"]
        r1 = client.head_request("pool_release",
                                 worker_id=bytes.fromhex(pooled_wid),
                                 grant_seq=-1, epoch=cur_epoch)
        r2 = client.head_request("pool_release",
                                 worker_id=bytes.fromhex(pooled_wid),
                                 grant_seq=-1, epoch=cur_epoch)
        assert r1 is True and r2 is True  # seq mismatch -> no-ops
        assert node_row()["pooled_workers"] == before
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        assert cluster.processes() == [] and cluster.segments() == []
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reap_jax_session(c):
    """The JAX package's `Cluster.shutdown` SIGKILLs its head and daemons,
    whose workers outlive them for their reconnect window and whose shm
    stays (ROADMAP queue 3): kill those workers and remove the segments,
    as the port's shutdown does on its own."""
    import glob
    import signal

    from ray_tpu_torch.cluster_utils import _session_pids

    for pid in _session_pids(c.session):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for seg in glob.glob(f"/dev/shm/rtpu_*{c.session[:8]}*"):
        try:
            os.unlink(seg)
        except OSError:
            pass


# ------------------------------------------------ the GPU actor's drill
def _gpu_actor_drill(pkg, cluster_cls, accel_kw, accel_res, inits_path):
    """chip_smoke phase 15's head restart on the CPU: a detached
    `num_<accel>=1` actor on a daemon, two one-accelerator nodes, the
    head SIGKILLed and restarted with --restore while the actor lives."""
    from importlib import import_module

    state = import_module(pkg.__name__ + ".util.state")
    c = cluster_cls(num_cpus=0, enable_snapshots=True)
    try:
        zones = {c.add_node(num_cpus=2, labels={"zone": z},
                            **{accel_kw: 1}): z for z in ("a", "b")}
        c.connect()
        c.wait_for_nodes(3)

        @pkg.remote
        class Server:
            def __init__(self, path):
                self.calls = 0
                with open(path, "a") as f:   # one line an instance
                    f.write(f"{os.getpid()}\n")

            def hit(self):
                self.calls += 1
                return (os.getpid(),
                        pkg.get_runtime_context().node_id.hex(), self.calls)

        @pkg.remote
        def where():
            return pkg.get_runtime_context().node_id.hex()

        h = Server.options(max_restarts=1, lifetime="detached",
                           name="drill-server", **{accel_kw: 1}).remote(
            str(inits_path))
        pid0, n1, calls = pkg.get(h.hit.remote(), timeout=60)
        assert n1 in zones and calls == 1
        epoch0 = next(r for r in state.list_scheduler_stats()
                      if r.get("is_head"))["epoch"]
        time.sleep(2.5)  # a snapshot cycle
        c.kill_head()
        c.restart_head(restore=True)
        after = pkg.get(h.hit.remote(), timeout=60)

        def reconciled():
            try:
                rows = [r for r in state.list_scheduler_stats()
                        if not r.get("is_head")]
            except Exception:
                return False  # this driver's own reconnect is under way
            return len(rows) == 2 and all(r["reconciled"] for r in rows)

        deadline = time.monotonic() + 60
        while not reconciled() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert reconciled()
        epoch1 = next(r for r in state.list_scheduler_stats()
                      if r.get("is_head"))["epoch"]
        # a lookup by name, then the head's own view of who hosts it
        fresh = pkg.get(pkg.get_actor("drill-server").hit.remote(),
                        timeout=60)
        client = import_module(pkg.__name__ + ".core.api")._global_client()
        aid = h._actor_id.hex()
        deadline = time.monotonic() + 30
        while True:
            alive = [a for a in client.head_request("list_state",
                                                    kind="actors")
                     if a["actor_id"] == aid and a["state"] == "ALIVE"]
            hosts = sorted(w["pid"] for w in client.head_request(
                "list_state", kind="workers") if w.get("actor") == aid)
            if (alive and hosts) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        avail = {n["node_id"]: n["available"].get(accel_res, 0)
                 for n in state.list_nodes()}
        total = pkg.cluster_resources().get(accel_res)
        # a second one-accelerator task pinned to the actor's node
        probe = where.options(label_selector={"zone": zones[n1]},
                              **{accel_kw: 1}).remote()
        ready, _ = pkg.wait([probe], timeout=3)
        pkg.cancel(probe, force=True)
        try:
            os.kill(pid0, 0)
            old_alive = True
        except ProcessLookupError:
            old_alive = False
        inits = [int(x) for x in inits_path.read_text().split()]
        return {"pid0": pid0, "n1": n1, "after": after, "fresh": fresh,
                "hosts": hosts, "old_alive": old_alive, "inits": inits,
                "epochs": (epoch0, epoch1), "avail_n1": avail.get(n1),
                "total": total, "probe_ran": bool(ready),
                "events": {e["kind"] for e in state.list_lease_events()}}
    finally:
        try:
            pkg.kill(pkg.get_actor("drill-server"))
        except Exception:
            pass
        pkg.shutdown()
        c.shutdown()
        if hasattr(c, "processes"):
            assert c.processes() == [] and c.segments() == []
        else:
            _reap_jax_session(c)


def test_gpu_actor_survives_head_restart_without_double_grant(tmp_path):
    """The restarted head re-adopts the actor's surviving process (its
    pid and state kept, found by name from a fresh lookup), its GPU stays
    debited on its node, and a second num_gpus=1 task pinned there does
    not run: no double grant. The epoch is bumped."""
    from ray_tpu_torch.cluster_utils import Cluster

    r = _gpu_actor_drill(ray_tpu_torch, Cluster, "num_gpus", "GPU",
                         tmp_path / "inits")
    assert r["inits"] == [r["pid0"]]  # never constructed again
    assert r["after"] == (r["pid0"], r["n1"], 2)
    assert r["fresh"] == (r["pid0"], r["n1"], 3)
    assert r["hosts"] == [r["pid0"]]
    assert r["epochs"][1] > r["epochs"][0]
    assert r["total"] == 2.0 and r["avail_n1"] == 0.0
    assert not r["probe_ran"]
    assert "actor_readopt" in r["events"]


def test_jax_package_recreates_a_surviving_detached_actor(tmp_path):
    """Pinned reference behaviour: the JAX package's restarted head
    re-creates the detached actor from its snapshot although its process
    survived on the daemon: a second construction, in a new process beside
    the old one (which keeps serving the driver's handle, the ledger
    counting only the new one) or in the old process, its state reset,
    whichever worker the head picks."""
    import ray_tpu
    import ray_tpu.cluster_utils

    r = _gpu_actor_drill(ray_tpu, ray_tpu.cluster_utils.Cluster,
                         "num_tpu_chips", "TPU", tmp_path / "inits")
    assert len(r["inits"]) == 2 and r["inits"][0] == r["pid0"]
    assert r["hosts"] == [r["inits"][1]]
    assert r["old_alive"]
    assert r["epochs"][1] > r["epochs"][0]
    assert "actor_readopt" not in r["events"]


# ------------------------------------ actor processes a daemon reports
def _restart_drill(detached, freeze):
    """One daemon with one GPU and idle workers, an actor holding the
    GPU, the head SIGKILLed and restarted with --restore, and a
    `num_gpus=1` task pinned to the node submitted the moment the head is
    back. With `freeze` the actor's process is stopped across the restart
    and resumed only after the node has reconciled and the task has had
    time to run: the window in which its GPU would read free. Every
    node's ledger is sampled until the actor answers and its process is
    re-adopted."""
    import signal

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import state

    c = Cluster(num_cpus=0, enable_snapshots=True)
    try:
        nid = c.add_node(num_cpus=2, num_gpus=1, labels={"zone": "a"})
        c.connect()
        c.wait_for_nodes(2)

        @ray_tpu_torch.remote
        class Keeper:
            def __init__(self):
                self.calls = 0

            def hit(self):
                self.calls += 1
                return os.getpid(), self.calls

        @ray_tpu_torch.remote
        def where():
            return os.getpid()

        opts = {"num_gpus": 1}
        if detached:
            opts.update(lifetime="detached", name="held-keeper",
                        max_restarts=1)
        h = Keeper.options(**opts).remote()
        pid0, _ = ray_tpu_torch.get(h.hit.remote(), timeout=60)
        pinned = where.options(label_selector={"zone": "a"})
        ray_tpu_torch.get([pinned.remote() for _ in range(4)], timeout=60)
        time.sleep(2.5)  # a snapshot cycle
        lows = []

        def sample():
            lows.extend(min(n["available"].get(r, 0) for r in ("CPU", "GPU"))
                        for n in state.list_nodes())

        if freeze:
            os.kill(pid0, signal.SIGSTOP)
        try:
            c.kill_head()
            c.restart_head(restore=True)
            probe = where.options(label_selector={"zone": "a"},
                                  num_gpus=1).remote()
            if freeze:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    try:
                        sample()
                        if all(r["reconciled"] for r in
                               state.list_scheduler_stats()
                               if not r.get("is_head")):
                            break
                    except Exception:
                        pass  # this driver's own reconnect is under way
                    time.sleep(0.1)
                ready, _ = ray_tpu_torch.wait([probe], timeout=3)
                sample()
        finally:
            if freeze:
                os.kill(pid0, signal.SIGCONT)
        after = hosts = None
        aid = h._actor_id.hex()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                sample()
                if after is None:
                    after = ray_tpu_torch.get(h.hit.remote(), timeout=5)
                hosts = [w["pid"] for w in state.list_workers()
                         if w.get("actor") == aid]
                if hosts:
                    break
            except Exception:
                pass
            time.sleep(0.1)
        ready, _ = ray_tpu_torch.wait([probe], timeout=3)
        ray_tpu_torch.cancel(probe, force=True)
        sample()
        avail = next(n["available"] for n in state.list_nodes()
                     if n["node_id"] == nid)
        events = [e for e in state.list_lease_events()
                  if e["kind"] == "actor_readopt"]
        return {"pid0": pid0, "after": after, "hosts": hosts,
                "lows": lows, "probe_ran": bool(ready),
                "gpu_free": avail.get("GPU", 0), "events": events}
    finally:
        if detached:
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor("held-keeper"))
            except Exception:
                pass
        ray_tpu_torch.shutdown()
        c.shutdown()
        assert c.processes() == [] and c.segments() == []


def test_non_detached_actor_on_a_daemon_outlives_head_restart():
    """An actor the snapshot does not hold (not detached) keeps its
    process through the head's restart and answers its owner's handle
    with its state, as the JAX package's does. Its daemon reports it, so
    the restarted head keeps it out of the idle pool and its GPU debited:
    a GPU task pinned to its node does not run."""
    r = _restart_drill(detached=False, freeze=False)
    assert r["after"] == (r["pid0"], 2)
    assert r["hosts"] == [r["pid0"]]
    assert r["gpu_free"] == 0.0 and not r["probe_ran"]
    assert min(r["lows"]) >= 0, r["lows"]
    assert [e["restored"] for e in r["events"]] == [False]


def test_gpu_task_pinned_straight_after_restart_gets_no_double_grant():
    """The detached GPU actor's process re-registers only after its node
    has reconciled (it is stopped until then) while a `num_gpus=1` task
    pinned to that node waits and the node has idle workers: the daemon's
    report holds the actor's GPU from the reconcile on, so no ledger goes
    below zero, the task does not run, and the actor keeps its process
    and its state."""
    r = _restart_drill(detached=True, freeze=True)
    assert min(r["lows"]) >= 0, r["lows"]
    assert not r["probe_ran"] and r["gpu_free"] == 0.0
    assert r["after"] == (r["pid0"], 2)
    assert r["hosts"] == [r["pid0"]]
    assert [e["restored"] for e in r["events"]] == [True]
