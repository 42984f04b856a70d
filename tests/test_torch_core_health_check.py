"""Hung-worker detection: liveness probes catch SIGSTOP'd processes.

The port's mirror of `tests/test_health_check.py`, against
`ray_tpu_torch`; each cluster must leave no process and no `rtpt_*`
segment of its session behind.

Reference: `src/ray/gcs/gcs_server/gcs_health_check_manager.h:45` — the
GCS actively health-checks processes; TCP disconnect alone cannot see a
hung-but-connected worker (SIGSTOP, deadlocked GIL, wedged PJRT call).
"""

import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import _session_pids


def _assert_session_clean(session):
    import glob

    from ray_tpu_torch.core.store import SHM_PREFIX

    deadline = time.monotonic() + 15
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _session_pids(session) == []
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}*{session[:8]}*") == []


def _assert_clean(c):
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()

FAST_HEALTH = {
    "RAY_TPU_HEALTH_CHECK_INTERVAL_S": "0.4",
    "RAY_TPU_HEALTH_CHECK_TIMEOUT_S": "0.4",
    "RAY_TPU_HEALTH_CHECK_MISSES": "2",
}


@pytest.fixture()
def fast_health_cluster(monkeypatch):
    for k, v in FAST_HEALTH.items():
        monkeypatch.setenv(k, v)
    ray_tpu_torch.shutdown()
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
    yield
    ray_tpu_torch.shutdown()
    _assert_session_clean(info["session"])


def test_sigstopped_actor_worker_is_declared_dead_and_restarts(
        fast_health_cluster):
    """SIGSTOP an actor's worker mid-call: the probe budget runs out, the
    head closes its socket, and the normal max_restarts path revives the
    actor — callers unblock instead of stalling forever."""

    @ray_tpu_torch.remote(max_restarts=2)
    class A:
        def pid(self):
            return os.getpid()

        def work(self):
            return "ok"

    a = A.remote()
    pid = ray_tpu_torch.get(a.pid.remote(), timeout=30)
    os.kill(pid, signal.SIGSTOP)
    try:
        # an in-flight call issued AFTER the freeze must not hang forever
        ref = a.work.remote()
        deadline = time.time() + 60
        revived = False
        while time.time() < deadline:
            try:
                new_pid = ray_tpu_torch.get(a.pid.remote(), timeout=5)
                if new_pid != pid:
                    revived = True
                    break
            except Exception:
                time.sleep(0.3)
        assert revived, "actor was not restarted after SIGSTOP"
        # the frozen-era call either completed on the new incarnation or
        # failed fast — either way it resolved
        try:
            ray_tpu_torch.get(ref, timeout=30)
        except Exception:
            pass
    finally:
        try:
            os.kill(pid, signal.SIGKILL)   # reap the frozen body
        except OSError:
            pass


def test_busy_worker_is_not_a_false_positive(fast_health_cluster):
    """A worker stuck in a LONG task stays healthy: probes are answered on
    the event loop while the task thread computes. 4s task >> miss budget
    (0.8s) — if execution blocked the probes this would flap."""

    @ray_tpu_torch.remote
    def long_task():
        time.sleep(4)
        return "survived"

    assert ray_tpu_torch.get(long_task.remote(), timeout=60) == "survived"


def test_sigstopped_node_daemon_detected():
    """A SIGSTOP'd node daemon is declared dead and its node leaves the
    alive set (reference node health checks), via the targeted
    Cluster.kill/stop_node seam the chaos suite needs."""
    from ray_tpu_torch.cluster_utils import Cluster

    for k, v in FAST_HEALTH.items():
        os.environ[k] = v
    try:
        ray_tpu_torch.shutdown()
        cluster = Cluster(num_cpus=1)
        try:
            nid = cluster.add_node(num_cpus=2)
            cluster.connect()
            cluster.wait_for_nodes(2)
            cluster.stop_node(nid)     # freeze, don't kill
            deadline = time.time() + 30
            while time.time() < deadline:
                alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
                if len(alive) == 1:
                    break
                time.sleep(0.3)
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            assert len(alive) == 1, "hung node daemon never declared dead"
        finally:
            ray_tpu_torch.shutdown()
            cluster.shutdown()
        _assert_clean(cluster)
    finally:
        for k in FAST_HEALTH:
            os.environ.pop(k, None)


def test_kill_node_by_id():
    """Cluster.kill_node accepts the node id add_node returned
    (reference cluster_utils kill-specific-node)."""
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster(num_cpus=1)
    try:
        nid1 = cluster.add_node(num_cpus=1,
                                labels={"victim": "no"})
        nid2 = cluster.add_node(num_cpus=1, labels={"victim": "yes"})
        cluster.connect()
        cluster.wait_for_nodes(3)
        cluster.kill_node(nid2)
        deadline = time.time() + 30
        while time.time() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            if len(alive) == 2:
                break
            time.sleep(0.2)
        alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        assert len(alive) == 2
        assert all(n["labels"].get("victim") != "yes" for n in alive
                   if not n["is_head"])
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    _assert_clean(cluster)
