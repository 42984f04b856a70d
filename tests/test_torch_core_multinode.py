"""Multi-node cluster: node daemons, label scheduling, PG strategies, GPUs
on each node, node death.

The port's mirror of `tests/test_multinode.py` (all but the TPU-slice
cases, which wait for ROADMAP item 21), against `ray_tpu_torch`, with
daemons advertising `num_gpus=2` where the reference's advertise
`num_tpu_chips=4`. Beside the mirror: the same cluster shape driven in
both packages (TPU chips in JAX, GPUs in the port) and compared; a lease
with a label selector that waits on a busy cluster; and the command line
of every process a port cluster starts. The cluster fixture checks at
teardown that no process and no `rtpt_*` segment of its session is left.
"""

import importlib
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import placement_group, remove_placement_group


def _running(pid):
    """True for a live process (not gone, not a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _assert_clean(c):
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_cpus=0)  # head schedules nothing itself
    try:
        c.add_node(num_cpus=4, labels={"zone": "a"})
        c.add_node(num_cpus=4, labels={"zone": "b"})
        # two GPU nodes of two cards each, each naming its own cards
        c.add_node(num_cpus=2, num_gpus=2, labels={"gpu_node": "0"},
                   env={"CUDA_VISIBLE_DEVICES": "0,1"})
        c.add_node(num_cpus=2, num_gpus=2, labels={"gpu_node": "1"},
                   env={"CUDA_VISIBLE_DEVICES": "2,3"})
        c.connect()
        c.wait_for_nodes(5)
        yield c
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    _assert_clean(c)


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


@ray_tpu_torch.remote
def where():
    return ray_tpu_torch.get_runtime_context().node_id.hex()


@ray_tpu_torch.remote
class Pin:
    def node(self):
        return ray_tpu_torch.get_runtime_context().node_id.hex()

    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_nodes_joined(cluster):
    nodes = ray_tpu_torch.nodes()
    assert len([n for n in nodes if n["alive"]]) == 5
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 12.0
    assert res["GPU"] == 4.0
    # the head advertises no GPU: Cluster starts it with --num-gpus 0
    head = [n for n in nodes if n["is_head"]][0]
    assert "GPU" not in head["resources"]


def test_tasks_run_on_worker_nodes(cluster):
    head_id = [n for n in ray_tpu_torch.nodes() if n["is_head"]][0]["node_id"]
    spots = ray_tpu_torch.get([where.remote() for _ in range(6)], timeout=60)
    assert all(s != head_id for s in spots)  # head has 0 CPUs


def test_label_selector(cluster):
    zone_b = [n for n in ray_tpu_torch.nodes()
              if n["labels"].get("zone") == "b"]
    assert len(zone_b) == 1
    out = ray_tpu_torch.get(
        where.options(label_selector={"zone": "b"}).remote(), timeout=60)
    assert out == zone_b[0]["node_id"]


def test_strict_spread_pg(cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)
    actors = [Pin.options(num_cpus=1, placement_group=pg,
                          placement_group_bundle_index=i).remote()
              for i in range(2)]
    nodes = ray_tpu_torch.get([a.node.remote() for a in actors], timeout=60)
    assert nodes[0] != nodes[1]
    for a in actors:
        ray_tpu_torch.kill(a)
    remove_placement_group(pg)


def test_gpu_nodes_get_their_own_cards(cluster):
    """A STRICT_SPREAD group of {"GPU": 2} bundles puts one actor on each
    GPU node; each sees the cards its daemon's CUDA_VISIBLE_DEVICES names
    (the core assigns no card ids: a node's cards reach its workers
    through the daemon's environment)."""
    pg = placement_group([{"GPU": 2, "CPU": 1}] * 2,
                         strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)
    actors = [Pin.options(num_cpus=1, num_gpus=2, placement_group=pg,
                          placement_group_bundle_index=i).remote()
              for i in range(2)]
    nodes = ray_tpu_torch.get([a.node.remote() for a in actors], timeout=60)
    seen = ray_tpu_torch.get([a.visible.remote() for a in actors],
                             timeout=60)
    gpu_nodes = {n["node_id"] for n in ray_tpu_torch.nodes()
                 if n["resources"].get("GPU")}
    assert set(nodes) == gpu_nodes
    assert sorted(seen) == ["0,1", "2,3"]
    for a in actors:
        ray_tpu_torch.kill(a)
    remove_placement_group(pg)


def test_every_process_runs_the_port(cluster):
    """Every process the cluster started (head, daemons, their workers)
    runs a ray_tpu_torch module, none a ray_tpu one; a worker on a daemon
    has neither JAX nor the JAX package loaded."""
    def probe():
        import sys as _sys

        return sorted(m for m in _sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu",
                                             "ml_dtypes"))

    assert ray_tpu_torch.get(
        ray_tpu_torch.remote(probe).options(
            label_selector={"zone": "a"}).remote(), timeout=60) == []
    pids = cluster.processes()
    assert len(pids) >= 5  # a head, four daemons, and workers
    kinds = set()
    for pid in pids:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().split(b"\0")
        mods = [a.decode() for a in argv if a.startswith(b"ray_tpu")]
        assert len(mods) == 1 and mods[0].startswith("ray_tpu_torch."), argv
        kinds.add(mods[0])
    assert {"ray_tpu_torch.core.head_main", "ray_tpu_torch.core.node_main",
            "ray_tpu_torch.core.worker_main"} <= kinds, kinds


def test_label_selector_lease_waits_for_a_matching_node(cluster, tmp_path):
    """A lease with a label selector that waits on a busy cluster is
    granted only on a matching node: a worker freed on another node does
    not take it (the selector check of `_grant_lease_waiters`). Without
    that check the zone-b worker is leased for the zone-a shape, and the
    next zone-a tasks run there while zone a is still full. A cluster of
    its own: no pool of an earlier test holds either zone's CPUs."""
    release_a, release_b = tmp_path / "a", tmp_path / "b"

    @ray_tpu_torch.remote(num_cpus=1)
    def hold(path, i):
        import os as _os
        import time as _time

        open(f"{path}.started{i}", "w").close()
        while not _os.path.exists(path):
            _time.sleep(0.05)
        return ray_tpu_torch.get_runtime_context().node_id.hex()

    ray_tpu_torch.shutdown()  # detach from the module cluster
    c = Cluster(num_cpus=0)
    try:
        by_zone = {z: c.add_node(num_cpus=2, labels={"zone": z})
                   for z in ("a", "b")}
        c.connect()
        c.wait_for_nodes(3)
        # fill both zones' CPUs, then ask for one more slot in zone a
        held = ([hold.options(label_selector={"zone": "a"}).remote(
            str(release_a), i) for i in range(2)]
            # zone b's run through the head's queue (a "spread" task takes
            # no lease), so their ends free head-known workers on zone b
            + [hold.options(label_selector={"zone": "b"},
                            scheduling_strategy="spread").remote(
                str(release_b), i) for i in range(2)])
        deadline = time.monotonic() + 60
        while len(list(tmp_path.glob("*.started*"))) < 4:
            assert time.monotonic() < deadline, "the holders never all ran"
            time.sleep(0.05)
        probe = where.options(label_selector={"zone": "a"}).remote()
        time.sleep(0.3)    # its lease ask now waits at the head
        release_b.touch()  # zone b frees its workers first
        assert ray_tpu_torch.get(held[2:], timeout=60) == [by_zone["b"]] * 2
        # more of the same shape: they would ride a lease granted on zone b
        probes = [probe] + [where.options(
            label_selector={"zone": "a"}).remote() for _ in range(3)]
        ready, _ = ray_tpu_torch.wait(probes, num_returns=len(probes),
                                      timeout=2)
        assert ready == []  # no freed zone-b worker took a zone-a lease
        release_a.touch()
        assert ray_tpu_torch.get(probes, timeout=60) == [by_zone["a"]] * 4
        assert ray_tpu_torch.get(held[:2], timeout=60) == [by_zone["a"]] * 2
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        cluster.connect()
    _assert_clean(c)


def test_node_death_actor_restart(cluster):
    # place an actor on a dedicated sacrificial node, then kill the node
    victim = cluster.add_node(num_cpus=1, labels={"victim": "yes"})
    cluster.wait_for_nodes(6)
    a = Pin.options(num_cpus=1, max_restarts=2,
                    label_selector={"victim": "yes"}).remote()
    assert ray_tpu_torch.get(a.node.remote(), timeout=60) == victim
    cluster.kill_node(len(cluster._nodes) - 1)
    # actor restarts somewhere else (selector can no longer match the dead
    # node; restart drops to any feasible node only if selector matches —
    # so use a second actor without selector to prove rescheduling works)
    b = Pin.options(num_cpus=1, max_restarts=2).remote()
    n1 = ray_tpu_torch.get(b.node.remote(), timeout=60)
    assert n1 != victim


def test_node_daemon_worker_logs_stream_to_head(cluster):
    """Workers spawned by NODE DAEMONS (not the head) get fd-level log
    capture in the node's subdir; the daemon's LogMonitor pushes lines
    to the head (log_batch) so get_log works cluster-wide — the
    multi-host half of the worker-log pipeline."""
    marker = f"nodelog-marker-{os.getpid()}"

    @ray_tpu_torch.remote(label_selector={"zone": "a"})
    def speak():
        print(marker, flush=True)
        return 1

    assert ray_tpu_torch.get(speak.remote(), timeout=60) == 1
    from ray_tpu_torch.core.api import _global_client

    cl = _global_client()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        hit = [row["file"] for row in cl.head_request("list_logs")
               if row["file"].endswith(".out")
               and any(marker in ln for ln in
                       cl.head_request("get_log",
                                       filename=row["file"]) or [])]
        if hit:
            return
        time.sleep(0.25)
    raise AssertionError("node-daemon worker's print never reached the head")


# --------------------------------------------------------------- parity
def _drive(pkg, cluster_cls, accel_kw, accel_res):
    """One cluster shape, driven through `pkg`'s public API: two CPU
    nodes in zones a and b, two accelerator nodes, a label-selected task,
    a STRICT_SPREAD group over the accelerator nodes, an actor restarted
    after its node's death. Returns what both packages must agree on."""
    c = cluster_cls(num_cpus=0)
    try:
        ids = {"a": c.add_node(num_cpus=2, labels={"zone": "a"}),
               "b": c.add_node(num_cpus=2, labels={"zone": "b"}),
               "x0": c.add_node(num_cpus=1, labels={"acc": "0"},
                                **{accel_kw: 2}),
               "x1": c.add_node(num_cpus=1, labels={"acc": "1"},
                                **{accel_kw: 2})}
        name_of = {v: k for k, v in ids.items()}
        c.connect()
        c.wait_for_nodes(5)
        out = {"nodes": len([n for n in pkg.nodes() if n["alive"]]),
               "total": dict(pkg.cluster_resources())}

        @pkg.remote
        def here():
            return pkg.get_runtime_context().node_id.hex()

        @pkg.remote
        class Where:
            def node(self):
                return pkg.get_runtime_context().node_id.hex()

        out["labelled"] = name_of[pkg.get(
            here.options(label_selector={"zone": "b"}).remote(),
            timeout=60)]
        pg = pkg.util.placement_group([{accel_res: 2, "CPU": 1}] * 2,
                                      strategy="STRICT_SPREAD")
        assert pg.ready(timeout=30)
        spread = [Where.options(num_cpus=1, resources={accel_res: 2},
                                placement_group=pg,
                                placement_group_bundle_index=i).remote()
                  for i in range(2)]
        out["spread"] = sorted(name_of[n] for n in pkg.get(
            [a.node.remote() for a in spread], timeout=60))
        for a in spread:
            pkg.kill(a)
        pkg.util.remove_placement_group(pg)
        # an accelerator actor on one accelerator node, then that node
        # dies: the head restarts it on the other. Read from the head's
        # record: the JAX package's kill_node leaves the old process
        # running, and a driver's handle may still reach it for a while
        act = Where.options(num_cpus=0, resources={accel_res: 1},
                            max_restarts=1).remote()
        first = name_of[pkg.get(act.node.remote(), timeout=60)]
        c.kill_node(ids[first])
        client = importlib.import_module(
            pkg.__name__ + ".core.api")._global_client()
        deadline = time.monotonic() + 60
        second = None
        while second is None and time.monotonic() < deadline:
            row = next(r for r in client.head_request("list_state",
                                                      kind="actors")
                       if r["actor_id"] == act._actor_id.hex())
            if row["state"] == "ALIVE" and row["node_id"] not in (
                    None, ids[first]):
                second = name_of[row["node_id"]]
            time.sleep(0.1)
        out["restart"] = sorted([first, second or first])
        return out
    finally:
        pkg.shutdown()
        c.shutdown()
        if pkg is not ray_tpu_torch:
            _reap_jax_session(c)


def test_cluster_shape_parity_with_jax_package(cluster):
    """The same cluster shape in both packages: node count, resource
    totals (TPU chips there, GPUs here), the label-selected and the
    STRICT_SPREAD placements, and the accelerator actor's restart on the
    other accelerator node after its node's death."""
    import ray_tpu
    import ray_tpu.cluster_utils
    import ray_tpu.util

    ray_tpu_torch.shutdown()  # detach from the module cluster
    try:
        ref = _drive(ray_tpu, ray_tpu.cluster_utils.Cluster,
                     "num_tpu_chips", "TPU")
        port = _drive(ray_tpu_torch, Cluster, "num_gpus", "GPU")
    finally:
        cluster.connect()
    assert ref["total"].pop("TPU") == port["total"].pop("GPU") == 4.0
    assert ref == port
    assert port["labelled"] == "b"
    assert port["spread"] == ["x0", "x1"]
    assert port["restart"] == ["x0", "x1"]


def test_kill_node_and_shutdown_leave_nothing_unlike_jax_package(cluster):
    """Pinned reference behaviour: the JAX package's `kill_node` SIGKILLs
    the daemon alone, so the node's workers live on (and re-register with
    the head), and its `Cluster.shutdown` SIGKILLs the head, whose arena
    stays in /dev/shm. The port's `kill_node` takes the node's workers
    with it, and its shutdown leaves no process and no segment."""
    import glob
    import signal

    import ray_tpu
    import ray_tpu.cluster_utils

    jax_c = []

    def drill(pkg, cluster_cls, prefix):
        c = cluster_cls(num_cpus=0)
        jax_c.append(c)
        try:
            c.add_node(num_cpus=1, labels={"zone": "k"})
            c.connect()
            c.wait_for_nodes(2)

            @pkg.remote
            def pid():
                return os.getpid()

            wpid = pkg.get(pid.options(label_selector={"zone": "k"}).remote(),
                           timeout=60)
            c.kill_node(0)
            time.sleep(1.0)
            alive = _running(wpid)
        finally:
            pkg.shutdown()
            c.shutdown()
        segs = glob.glob(f"/dev/shm/{prefix}*{c.session[:8]}*")
        return wpid, alive, segs

    ray_tpu_torch.shutdown()  # detach from the module cluster
    try:
        wpid, alive, segs = drill(ray_tpu, ray_tpu.cluster_utils.Cluster,
                                  "rtpu_")
        try:
            assert alive, "the JAX package's node worker died with its daemon"
            assert segs, "the JAX package's shutdown left no segment"
        finally:
            try:
                os.kill(wpid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            _reap_jax_session(jax_c[0])
        wpid, alive, segs = drill(ray_tpu_torch, Cluster, "rtpt_")
        assert not alive and segs == []
    finally:
        cluster.connect()
