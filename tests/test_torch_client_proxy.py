"""Remote driver proxy (`ray-tpu://` — Ray Client equivalent).

Reference parity: `python/ray/util/client/` — a driver that can reach
ONLY the proxy port runs the full task/actor/object API. The driver runs
in a subprocess that is told nothing but `ray-tpu://127.0.0.1:<port>`.

The port's mirror of `tests/test_client_proxy.py`'s three tests, against
`ray_tpu_torch`'s client proxy, and a remote driver of a multi-node port
cluster: its tasks reach a daemon's node, and neither the driver nor the
per-client proxy process loads JAX or the JAX package. Each cluster must
leave no process and no `rtpt_*` segment of its session behind.
"""

import os
import subprocess
import sys
import textwrap
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


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
    yield
    ray_tpu_torch.shutdown()
    _assert_session_clean(info["session"])


def _proxy_port():
    from ray_tpu_torch.core.api import _global_client

    info = _global_client().head_request("cluster_info")
    return info.get("client_proxy_port")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = textwrap.dedent(f"""
    import sys
    sys.path.insert(0, {REPO!r})
""") + textwrap.dedent("""
    import gc, sys, time
    import ray_tpu_torch

    addr = sys.argv[1]
    info = ray_tpu_torch.init(address=addr)
    assert info.get("session"), info

    # ---- objects
    ref = ray_tpu_torch.put({"x": 41})
    assert ray_tpu_torch.get(ref)["x"] == 41

    # ---- tasks (args, kwargs, ref args, multiple returns)
    @ray_tpu_torch.remote
    def add(a, b=0):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, b=2)) == 3
    assert ray_tpu_torch.get(add.remote(ray_tpu_torch.get(ref)["x"], b=1)) == 42

    @ray_tpu_torch.remote
    def nested(d):
        return ray_tpu_torch.get(d["r"]) + 1

    inner = ray_tpu_torch.put(10)
    assert ray_tpu_torch.get(nested.remote({"r": inner})) == 11

    @ray_tpu_torch.remote(num_returns=2)
    def two():
        return 1, 2

    r1, r2 = two.remote()
    assert ray_tpu_torch.get([r1, r2]) == [1, 2]

    # ---- errors propagate with type info
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kapow")

    try:
        ray_tpu_torch.get(boom.remote())
        raise AssertionError("expected TaskError")
    except Exception as e:
        assert "kapow" in str(e), e

    # ---- wait
    refs = [add.remote(i, b=0) for i in range(4)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=2, timeout=30)
    assert len(ready) == 2 and len(rest) == 2

    # ---- streaming generators
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    got = [ray_tpu_torch.get(r) for r in gen.remote(3)]
    assert got == [0, 10, 20], got

    # ---- actors: state, named handle, kill
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def incr(self, by=1):
            self.v += by
            return self.v

    c = Counter.options(name="proxy-counter").remote(100)
    assert ray_tpu_torch.get(c.incr.remote()) == 101
    assert ray_tpu_torch.get(c.incr.remote(by=4)) == 105
    c2 = ray_tpu_torch.get_actor("proxy-counter")
    assert ray_tpu_torch.get(c2.incr.remote()) == 106
    ray_tpu_torch.kill(c)

    # ---- state API over the proxied control plane
    from ray_tpu_torch.core.api import _global_client
    cl = _global_client()
    rows = cl.head_request("list_state", kind="workers")
    assert any(w["is_driver"] for w in rows)

    # ---- kv
    cl.kv_put("proxy-test", b"k", b"v")
    assert cl.kv_get("proxy-test", b"k") == b"v"

    # ---- refcount mirror: a dropped remote ref evicts at the head
    import numpy as np
    big = ray_tpu_torch.put(np.ones(300_000, dtype=np.uint8))
    oid = big.hex()
    def object_ids():
        return {o["object_id"] for o in cl.head_request(
            "list_state", kind="objects")}
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and oid not in object_ids():
        time.sleep(0.1)
    assert oid in object_ids()
    del big
    gc.collect()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and oid in object_ids():
        time.sleep(0.2)
    assert oid not in object_ids(), "remote ref drop did not evict"

    # ---- worker prints stream to THIS remote terminal (relayed logs)
    @ray_tpu_torch.remote
    def shout():
        print("proxy-log-marker", flush=True)
        return 7

    assert ray_tpu_torch.get(shout.remote()) == 7
    deadline = time.monotonic() + 15
    # the relay lands on our stderr asynchronously; just give it time
    time.sleep(2)

    ray_tpu_torch.shutdown()
    print("PROXY-MATRIX-OK")
""")


def test_remote_driver_full_matrix(cluster, tmp_path):
    port = _proxy_port()
    assert port, "head did not start a client proxy"
    script = tmp_path / "driver.py"
    script.write_text(DRIVER)
    env = dict(os.environ)
    env.pop("RAY_TPU_ADDRESS", None)
    env["RAY_TPU_EVICT_GRACE_S"] = "0"
    out = subprocess.run(
        [sys.executable, str(script), f"ray-tpu://127.0.0.1:{port}"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))  # non-repo cwd: nothing importable but the pkg
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    assert "PROXY-MATRIX-OK" in out.stdout
    # a task print() reached the REMOTE driver's terminal via the relay
    assert "proxy-log-marker" in out.stderr, out.stderr[-2000:]


def test_proxy_session_cleanup_on_disconnect(cluster):
    """The per-client server process exits when its remote disconnects."""
    port = _proxy_port()
    script = ("import ray_tpu_torch, sys; "
              f"ray_tpu_torch.init(address='ray-tpu://127.0.0.1:{port}'); "
              "print('CONNECTED', flush=True)")
    env = dict(os.environ)
    env.pop("RAY_TPU_ADDRESS", None)
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120, env=env)
    assert "CONNECTED" in out.stdout, out.stderr
    # after the remote exits, no lingering proxy-worker driver keeps
    # registering as a driver forever
    from ray_tpu_torch.core.api import _global_client

    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        rows = _global_client().head_request("list_state", kind="workers")
        drivers = [w for w in rows if w["is_driver"]]
        if len(drivers) <= 1:  # just this pytest driver
            return
        time.sleep(0.5)
    raise AssertionError(f"proxy drivers lingered: {drivers}")


def test_two_concurrent_remote_drivers_are_isolated(cluster, tmp_path):
    """Each remote client gets its OWN server-side driver process
    (reference proxier model): two simultaneous drivers submit work
    under the same proxy port without sharing refs or state."""
    port = _proxy_port()
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import ray_tpu_torch

        tag = sys.argv[1]
        ray_tpu_torch.init(address="ray-tpu://127.0.0.1:{port}")

        @ray_tpu_torch.remote
        def work(x):
            return f"{{x}}-done"

        @ray_tpu_torch.remote
        class Holder:
            def __init__(self, t):
                self.t = t

            def get(self):
                return self.t

        h = Holder.options(name=f"holder-{{tag}}").remote(tag)
        outs = ray_tpu_torch.get([work.remote(f"{{tag}}-{{i}}") for i in range(8)])
        assert outs == [f"{{tag}}-{{i}}-done" for i in range(8)], outs
        assert ray_tpu_torch.get(h.get.remote()) == tag
        # the OTHER driver's named actor is visible cluster-wide (shared
        # control plane), but this driver's objects are its own
        print(f"DRIVER-{{tag}}-OK")
        ray_tpu_torch.shutdown()
    """)
    p = tmp_path / "cdrv.py"
    p.write_text(script)
    env = dict(os.environ)
    env.pop("RAY_TPU_ADDRESS", None)
    procs = [subprocess.Popen([sys.executable, str(p), t],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for t in ("alpha", "beta")]
    outs = [pr.communicate(timeout=300) for pr in procs]
    for (stdout, stderr), tag in zip(outs, ("alpha", "beta")):
        assert f"DRIVER-{tag}-OK" in stdout, stderr[-1500:]


REMOTE_ON_DAEMON = textwrap.dedent(f"""
    import sys
    sys.path.insert(0, {REPO!r})
""") + textwrap.dedent("""
    import json, os, sys
    import ray_tpu_torch

    ray_tpu_torch.init(address=sys.argv[1])

    @ray_tpu_torch.remote(label_selector={"zone": "a"})
    def where():
        import sys as _sys
        return (ray_tpu_torch.get_runtime_context().node_id.hex(),
                sorted(m for m in _sys.modules
                       if m.split(".")[0] in ("jax", "ray_tpu")))

    node, foreign = ray_tpu_torch.get(where.remote(), timeout=120)
    rows = ray_tpu_torch.core.api._global_client().head_request(
        "list_state", kind="workers")
    proxy_pids = [w["pid"] for w in rows if w["is_driver"]
                  and w["pid"] not in (os.getpid(), int(sys.argv[2]))]
    mine = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "torch"))
    print(json.dumps({"node": node, "foreign": foreign, "mine": mine,
                      "proxy_cmdlines": [
                          open(f"/proc/{p}/cmdline", "rb").read().decode()
                          .split("\\0") for p in proxy_pids]}))
    ray_tpu_torch.shutdown()
""")


def test_remote_driver_of_a_multinode_cluster(tmp_path):
    """`init("ray-tpu://...")` against a head with no CPUs and one daemon:
    the remote driver's task lands on the daemon's node; the driver has
    loaded neither torch nor JAX nor the JAX package, and its server-side
    driver runs `ray_tpu_torch.client_proxy.worker`."""
    import json

    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()  # detach from the module cluster
    c = Cluster(num_cpus=0)
    try:
        nid = c.add_node(num_cpus=2, labels={"zone": "a"})
        c.connect()
        c.wait_for_nodes(2)
        port = _proxy_port()
        assert port, "head did not start a client proxy"
        script = tmp_path / "remote.py"
        script.write_text(REMOTE_ON_DAEMON)
        env = dict(os.environ)
        env.pop("RAY_TPU_ADDRESS", None)
        out = subprocess.run(
            [sys.executable, str(script), f"ray-tpu://127.0.0.1:{port}",
             str(os.getpid())],
            capture_output=True, text=True, timeout=120, env=env,
            cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["node"] == nid
        assert res["foreign"] == [] and res["mine"] == []
        assert res["proxy_cmdlines"], res
        for argv in res["proxy_cmdlines"]:
            assert "ray_tpu_torch.client_proxy.worker" in argv, argv
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    assert c.processes() == [] and c.segments() == []
