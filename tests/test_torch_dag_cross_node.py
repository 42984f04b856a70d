"""Cross-node compiled-DAG channels in the port: a host pipeline whose
stages live on DIFFERENT nodes.

The port's mirror of `tests/test_dag_cross_node.py` (5 cases) against
`ray_tpu_torch.dag`, on a `cluster_utils` cluster of two node daemons
under store isolation (every node its own shm namespace, so a cross-node
read really travels through the writer process's `dag_chan_read` RPC and a
device snapshot through the chunked data plane). The pipelines carry
torch tensors where the reference's carry Python numbers; the device edge
carries a tensor that stays in its producer's device store. The fixture
checks that no process and no `rtpt_*` segment of the session is left,
and every case that the DAG's rings are gone after `teardown`.
"""

import os
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.native_store import native_available

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")


@pytest.fixture(scope="module")
def two_node_cluster():
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = None
    try:
        c = Cluster(num_cpus=1)
        c.add_node(num_cpus=4, resources={"stage1": 4})
        c.add_node(num_cpus=4, resources={"stage2": 4})
        c.connect()
        c.wait_for_nodes(3)
        yield c
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
        if c is not None:
            c.shutdown()
    assert c.processes() == [], c.processes()
    assert c.segments() == [], c.segments()


def _actor_node(handle):
    from ray_tpu_torch.core.api import _global_client

    return _global_client().head_request(
        "get_actor_address", actor_id=handle._actor_id.binary())["node_id"]


def _assert_rings_gone(cdag):
    left = [n for n in cdag.chan_names.values()
            if os.path.exists(f"/dev/shm/{n}")]
    assert left == [], left


def test_cross_node_two_stage_pipeline(two_node_cluster):
    """input (driver node) -> stage1 (node A) -> stage2 (node B) ->
    driver: every edge crosses a process boundary, two cross nodes."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class Stage1:
        def fwd(self, x):
            return x + 1

    @ray_tpu_torch.remote(resources={"stage2": 1})
    class Stage2:
        def fwd(self, y):
            return y * 10

    s1, s2 = Stage1.remote(), Stage2.remote()
    with InputNode() as inp:
        dag = s2.fwd.bind(s1.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        assert torch.equal(cdag.execute(torch.zeros(3)).get(timeout=60),
                           torch.full((3,), 10.0))
        assert _actor_node(s1) != _actor_node(s2), \
            "stages must be on different nodes for this test to mean anything"
        n = 30
        t0 = time.perf_counter()
        for i in range(n):
            got = cdag.execute(torch.full((3,), float(i))).get(timeout=60)
            assert torch.equal(got, torch.full((3,), (i + 1) * 10.0))
        per_iter = (time.perf_counter() - t0) / n
        print(f"\ncross-node pipeline: {per_iter * 1e3:.2f} ms/iter")
        assert per_iter < 1.0, "cross-node pipeline pathologically slow"
    finally:
        cdag.teardown(kill_actors=True)
    _assert_rings_gone(cdag)


def test_cross_node_pipelined_iterations_overlap(two_node_cluster):
    """GPipe property: submit K inputs before reading any output — the
    stages work concurrently, the rings provide the backpressure."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class A:
        def fwd(self, x):
            return x * 2

    @ray_tpu_torch.remote(resources={"stage2": 1})
    class B:
        def fwd(self, x):
            return x + 5

    a, b = A.remote(), B.remote()
    with InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        refs = [cdag.execute(i) for i in range(2)]   # pipeline depth 2
        assert [r.get(timeout=60) for r in refs] == [5, 7]
        refs = [cdag.execute(i) for i in range(2, 4)]
        assert [r.get(timeout=60) for r in refs] == [9, 11]
    finally:
        cdag.teardown(kill_actors=True)
    _assert_rings_gone(cdag)


def test_cross_node_fan_in(two_node_cluster):
    """Two producers on different nodes fan into one consumer (a local
    and a remote reader on the consumer's side)."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class P1:
        def fwd(self, x):
            return x + 100

    @ray_tpu_torch.remote(resources={"stage2": 1})
    class P2:
        def fwd(self, x):
            return x + 200

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class Sum:
        def add(self, u, v):
            return u + v

    p1, p2, s = P1.remote(), P2.remote(), Sum.remote()
    with InputNode() as inp:
        dag = s.add.bind(p1.fwd.bind(inp), p2.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for i in range(5):
            got = cdag.execute(torch.tensor([i, -i])).get(timeout=60)
            assert torch.equal(got, torch.tensor([2 * i + 300,
                                                  -2 * i + 300]))
    finally:
        cdag.teardown(kill_actors=True)
    _assert_rings_gone(cdag)


@pytest.mark.chaos
def test_cross_node_edge_survives_chaos_delay(two_node_cluster):
    """A seeded chaos delay plan on the remote-reader edge
    (`dag_chan_read` RPCs) stretches hops but never corrupts them: the
    results stay correct and in order, iterations still pipelined."""
    from ray_tpu_torch.core import protocol
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class A:
        def fwd(self, x):
            return x * 3

    @ray_tpu_torch.remote(resources={"stage2": 1})
    class B:
        def fwd(self, x):
            return x + 7

    a, b = A.remote(), B.remote()
    with InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    cdag = dag.experimental_compile(max_inflight=4)
    try:
        assert cdag.execute(0).get(timeout=60) == 7   # warm
        protocol.configure_chaos(
            "seed=11,delay:dag_chan_read@*:p=0.5:t=0.05")
        try:
            refs = [cdag.execute(i) for i in range(1, 9)]
            got = [r.get(timeout=120) for r in refs]
        finally:
            protocol.configure_chaos("")
        assert got == [i * 3 + 7 for i in range(1, 9)]
    finally:
        cdag.teardown(kill_actors=True)
    _assert_rings_gone(cdag)


def test_cross_node_device_tensor_pipeline(two_node_cluster):
    """A 2-stage pipeline on DIFFERENT nodes whose inter-stage edge
    carries a DEVICE tensor: the ring moves only a descriptor, the tensor
    reaches the consumer through the device-object plane (a snapshot
    pulled across nodes), bit-equal."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(resources={"stage1": 1})
    class Embed:
        @ray_tpu_torch.method(tensor_transport="device")
        def fwd(self, x):
            return torch.arange(16.0).reshape(4, 4) + float(x)

    @ray_tpu_torch.remote(resources={"stage2": 1})
    class Head:
        def fwd(self, h):
            assert isinstance(h, torch.Tensor), type(h)
            return float(h.sum())

    e, h = Embed.remote(), Head.remote()
    with InputNode() as inp:
        dag = h.fwd.bind(e.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        base = float(sum(range(16)))
        for i in range(4):
            assert cdag.execute(i).get(timeout=60) == base + 16.0 * i
    finally:
        cdag.teardown(kill_actors=True)
    _assert_rings_gone(cdag)
