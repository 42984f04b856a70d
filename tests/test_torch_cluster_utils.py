"""`cluster_utils.VirtualNodes` against the port's head: the gossip
convergence smokes of `tests/test_resource_view.py`, at the reference's
own sizes.

Virtual nodes are node registrations over real sockets with no daemon
behind them: every view, gossip and shard path of the head runs for
real, and their one resource (`vslot`) never fits a task, so nothing is
placed on them.
"""

import os
import time

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import VirtualNodes


def _client():
    return ray_tpu_torch.core.api._global_client()


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(what)


def test_200_virtual_node_gossip_convergence():
    """200 registered nodes: the driver's cached view converges to the
    full membership, re-converges after a node death, the virtual nodes'
    own views converge too, and the control plane still schedules."""
    N = 200
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    vnodes = None
    try:
        c = _client()
        vnodes = VirtualNodes(c.head_host, c.head_port, N)
        vnodes.start()
        _wait(lambda: len(c.cluster_view.entries) >= N + 1, 60,
              "view never reached full size")
        vnodes.kill(0)
        _wait(lambda: len(c.cluster_view.entries) == N, 60,
              "view never dropped the dead node")

        def node_side():
            snap = vnodes.views[1]["snap"]
            return snap is not None and len(snap["nodes"]) == N

        _wait(node_side, 30, "node-side view did not converge after the death")

        @ray_tpu_torch.remote
        def plus(x):
            return x + 1

        assert ray_tpu_torch.get([plus.remote(i) for i in range(20)],
                                 timeout=120) == [i + 1 for i in range(20)]
    finally:
        if vnodes is not None:
            vnodes.stop()
        ray_tpu_torch.shutdown()


def test_sharded_view_gossip_convergence_small():
    """48 interest-scoped virtual nodes over 8 shards: each converges on
    its own shard and a digest of the whole cluster without ever getting
    a full-fanout push, and a dead node leaves the driver's view and its
    shard peer's."""
    from ray_tpu_torch.core.resource_view import shard_of

    n_nodes, n_shards = 48, 8
    saved = {k: os.environ.get(k) for k in
             ("RAY_TPU_VIEW_SHARDS", "RAY_TPU_VIEW_DIGEST_REFRESH_S")}
    os.environ["RAY_TPU_VIEW_SHARDS"] = str(n_shards)
    os.environ["RAY_TPU_VIEW_DIGEST_REFRESH_S"] = "5.0"
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    vnodes = None
    try:
        c = _client()
        vnodes = VirtualNodes(c.head_host, c.head_port, n_nodes)
        vnodes.start(timeout=120)
        _wait(lambda: len(c.cluster_view.entries) >= n_nodes + 1, 120,
              "driver view never reached full size")
        by_shard: dict = {}
        for h in vnodes.node_ids:
            by_shard.setdefault(shard_of(h, n_shards), set()).add(h)
        for i in (0, n_nodes // 2, n_nodes - 1):
            slot, me = vnodes.views[i], vnodes.node_ids[i]
            mine = by_shard[shard_of(me, n_shards)]

            def converged():
                view = slot["view"]
                have = {h for h in view.entries
                        if shard_of(h, n_shards) == shard_of(me, n_shards)}
                return (mine <= have and (view.digest or {}).get(
                    "total_nodes", 0) >= n_nodes + 1)

            _wait(converged, 90, f"vnode {i} never converged")
            assert me in slot["view"].entries
            assert slot["max_push"] < n_nodes, (
                f"vnode {i} received a full-fanout push "
                f"({slot['max_push']} entries for {n_nodes} nodes)")
        victim = vnodes.node_ids[0]
        witness = next((j for j in range(1, n_nodes)
                        if shard_of(vnodes.node_ids[j], n_shards)
                        == shard_of(victim, n_shards)), None)
        vnodes.kill(0)
        _wait(lambda: victim not in c.cluster_view.entries, 90,
              "driver view never dropped the dead node")
        if witness is not None:
            _wait(lambda: victim not in vnodes.views[witness]["view"].entries,
                  90, "shard peer never dropped the dead node")

        @ray_tpu_torch.remote
        def plus(x):
            return x + 1

        assert ray_tpu_torch.get([plus.remote(i) for i in range(5)],
                                 timeout=120) == [i + 1 for i in range(5)]
    finally:
        if vnodes is not None:
            vnodes.stop()
        ray_tpu_torch.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
