"""The compiled serve ingress in the port (`serve/compiled_chain.py` and
the proxy's chain), mirroring `tests/test_compiled_chain.py` and
`tests/test_compiled_proxy.py` against `ray_tpu_torch`.

- a chain of two deployments: values flow stage to stage through the
  rings, a user error fails only its own request, and warm requests make
  zero head round trips (the RPC interposer in this process);
- SIGKILL of a chain replica mid-burst: the generation fences, every
  request still answers (dynamic failover), and the chain recompiles over
  the controller's replacement;
- `serve.run(..., compiled=True)` over HTTP: lanes spread over both
  replicas, warm requests make zero head round trips from the proxy
  process, and a replica SIGKILL under HTTP load never surfaces a 500;
- the lanes' replica assignment for the same sorted tags equals the JAX
  package's `CompiledServeChain` (both compiled over stand-in handles);
- `build_llm_deployment` served compiled over HTTP: its greedy answers
  equal the JAX package's `LLMServer` called in-process on one seeded
  float32 checkpoint.

Deployment classes are defined inside the tests, so that they ship by
value and no replica imports this module (and JAX with it).
"""

import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.serve import compiled_chain as JC
from ray_tpu.serve import llm as JS
from ray_tpu_torch import serve
from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.native_store import native_available
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve import compiled_chain as PC
from ray_tpu_torch.serve.compiled_chain import CompiledServeChain
from ray_tpu_torch.serve.llm import build_llm_deployment

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")

TIMEOUT = 120
CHAIN = {"lanes": 2, "max_inflight": 2, "batch_max": 4,
         "entry_timeout_s": 60, "recompile_timeout_s": 120}


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=16)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _stages():
    class Pre:
        def __call__(self, v):
            return {**v, "x": v["x"] + 1}

    class Main:
        def __call__(self, v):
            if v.get("boom"):
                raise ValueError("user boom")
            return {"y": v["x"] * 10}

        def pid(self, _=None):
            return os.getpid()

    return Pre, Main


def _deploy_chain(tag: str) -> list:
    Pre, Main = _stages()
    serve.run(serve.deployment(Pre, name=f"pre-{tag}").bind(),
              name=f"pre-{tag}")
    serve.run(serve.deployment(Main, name=f"main-{tag}").bind(),
              name=f"main-{tag}")
    return [f"pre-{tag}", f"main-{tag}"]


def test_chain_correctness_and_user_error_isolation(cluster):
    deps = _deploy_chain("basic")
    chain = CompiledServeChain(deps, lanes=2, max_inflight=2,
                               batch_max=4).start()
    try:
        assert chain.call({"x": 1}, timeout=30) == {"y": 20}
        resps = [chain.submit({"x": i}) for i in range(20)]
        assert [r.result(30) for r in resps] == \
            [{"y": (i + 1) * 10} for i in range(20)]
        bad = chain.submit({"x": 1, "boom": True})
        good = chain.submit({"x": 2})
        assert good.result(30) == {"y": 30}
        with pytest.raises(RuntimeError, match="user boom"):
            bad.result(30)
        assert chain.is_compiled()
        assert chain.stats["fenced"] == 0
        assert chain.stats["dynamic_fallback"] == 0
    finally:
        chain.shutdown()
        for d in deps:
            serve.delete(d)


def test_chain_warm_path_makes_zero_head_rpcs(cluster):
    deps = _deploy_chain("rpc")
    chain = CompiledServeChain(deps, lanes=2, max_inflight=2,
                               batch_max=4).start()
    try:
        for i in range(5):   # every lane and both replicas warm
            assert chain.call({"x": i}, timeout=30) == {"y": (i + 1) * 10}
        time.sleep(0.3)      # registration stragglers flush

        events = []

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        protocol.add_rpc_interposer(hook)
        try:
            resps = [chain.submit({"x": i}) for i in range(25)]
            out = [r.result(30) for r in resps]
        finally:
            protocol.remove_rpc_interposer(hook)
        assert out == [{"y": (i + 1) * 10} for i in range(25)]
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"warm compiled path made head round trips: {reqs}"
        pushes = {m for k, m in events if k == "push"}
        assert pushes <= {"ref_update", "metrics_push"}, pushes
        assert chain.stats["dynamic_fallback"] == 0
    finally:
        chain.shutdown()
        for d in deps:
            serve.delete(d)


@pytest.mark.chaos
def test_chain_actor_sigkill_mid_step_recompiles(cluster):
    deps = _deploy_chain("chaos")
    chain = CompiledServeChain(deps, lanes=2, max_inflight=2, batch_max=4,
                               entry_timeout_s=30,
                               recompile_timeout_s=90).start()
    try:
        assert chain.call({"x": 1}, timeout=30) == {"y": 20}
        victim_tag = dict(chain.targets())[deps[1]]
        victim_pid = serve.get_deployment_handle(deps[1]).options(
            method_name="pid").remote({}).result(timeout=30)
        gen0 = chain.generation
        rings = _chain_rings(chain)

        resps = [chain.submit({"x": i}) for i in range(8)]
        os.kill(victim_pid, signal.SIGKILL)
        resps += [chain.submit({"x": i}) for i in range(8, 24)]
        vals = [r.result(120) for r in resps]
        assert vals == [{"y": (i + 1) * 10} for i in range(24)], \
            "a request failed across the replica kill"
        assert chain.stats["fenced"] >= 1
        assert chain.stats["dynamic_fallback"] >= 1

        assert chain.wait_compiled(90), "chain never recompiled"
        assert chain.generation > gen0
        new_tag = dict(chain.targets())[deps[1]]
        assert new_tag != victim_tag, (new_tag, victim_tag)

        deadline = time.time() + 30
        while (time.time() < deadline
               and not (chain.is_compiled() and chain._subq.empty())):
            time.sleep(0.2)
        before = chain.stats["compiled"]
        resps = [chain.submit({"x": i}) for i in range(8)]
        assert [r.result(60) for r in resps] == \
            [{"y": (i + 1) * 10} for i in range(8)]
        assert chain.stats["compiled"] > before, (chain.stats, chain.events)
        rings |= _chain_rings(chain)
    finally:
        chain.shutdown()
        for d in deps:
            serve.delete(d)
    # both generations' rings are gone, the dead replica's among them
    assert [n for n in rings if os.path.exists(f"/dev/shm/{n}")] == []


def _chain_rings(chain) -> set:
    return {n for cd in chain._cdags for n in cd.chan_names.values()}


# ------------------------------------------------- lanes against JAX's
class _Ref:
    def get(self, timeout=None):
        return []


class _Cdag:
    def execute(self, value, timeout=None):
        return _Ref()

    def teardown(self):
        pass


class _Node:
    def experimental_compile(self, **kw):
        return _Cdag()


class _Handle:
    """A stand-in replica handle: `handle_chain.bind` and an actor id,
    all that `_compile` reads."""

    def __init__(self, tag):
        self.handle_chain = types.SimpleNamespace(bind=lambda node: _Node())
        self._actor_id = types.SimpleNamespace(binary=lambda: tag.encode())


@pytest.mark.parametrize("lanes", [1, 2, 3, 5])
def test_lane_assignment_matches_jax(monkeypatch, lanes):
    import ray_tpu.core.api as japi

    import ray_tpu_torch.core.api as papi

    client = types.SimpleNamespace(cluster_epoch=3)
    monkeypatch.setattr(japi, "_global_client", lambda: client)
    monkeypatch.setattr(papi, "_global_client", lambda: client)
    tags = {"front": ["front#b", "front#a"],
            "model": ["model#z3", "model#x1", "model#y2"]}
    got = []
    for mod in (JC, PC):
        chain = mod.CompiledServeChain(list(tags), lanes=lanes,
                                       controller=object())
        chain._resolve_targets = lambda exclude=None: [
            (dep, {t: _Handle(t) for t in ts}) for dep, ts in tags.items()]
        chain._compile()
        got.append(chain.lane_targets())
        assert chain.epoch == 3 and chain.generation == 1
    assert got[0] == got[1]
    assert [lane[0][1] for lane in got[1]] == [
        sorted(tags["front"])[i % 2] for i in range(lanes)]


# ------------------------------------------------------ HTTP ingress
def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _wait_chain_live(proxy, dep: str, timeout: float = 120.0) -> dict:
    deadline = time.time() + timeout
    st = {}
    while time.time() < deadline:
        st = ray_tpu_torch.get(proxy.chain_status.remote(dep), timeout=30)
        if st.get("live"):
            return st
        time.sleep(0.25)
    raise AssertionError(f"proxy chain for {dep} never went live: {st}")


def _deploy_echo(tag: str):
    class Echo:
        def __call__(self, request):
            return {"ok": True, "x": request.get("x"), "pid": os.getpid()}

    dep = f"cproxy-{tag}"
    serve.run(
        serve.deployment(Echo, name=dep).options(
            num_replicas=2, max_ongoing_requests=16,
            chain_config=CHAIN).bind(),
        name=dep, route_prefix=f"/{dep}", compiled=True)
    port = serve.start()
    url = f"http://127.0.0.1:{port}/{dep}"
    # the first request primes the router, which starts the chain
    assert _post(url, {"x": 0})["ok"]
    proxy = ray_tpu_torch.get_actor("serve-proxy")
    return dep, url, proxy, _wait_chain_live(proxy, dep)


def test_http_over_compiled_ingress_spreads_lanes(cluster):
    dep, url, proxy, st = _deploy_echo("spread")
    try:
        lane_tags = {t for lane in st["lane_targets"] for _d, t in lane}
        assert len(lane_tags) == 2, st["lane_targets"]
        n = 24
        pids = []
        for i in range(1, n + 1):
            out = _post(url, {"x": i})
            assert out["ok"] and out["x"] == i
            pids.append(out["pid"])
        counts = {p: pids.count(p) for p in set(pids)}
        assert len(counts) == 2, counts
        assert min(counts.values()) >= n // 4, counts
        st = ray_tpu_torch.get(proxy.chain_status.remote(dep), timeout=30)
        assert st["stats"]["compiled"] >= n, st["stats"]
    finally:
        serve.delete(dep)


def test_warm_proxy_requests_make_zero_head_rpcs(cluster):
    dep, url, proxy, _st = _deploy_echo("audit")
    try:
        for i in range(6):
            assert _post(url, {"x": i})["ok"]
        assert ray_tpu_torch.get(proxy.rpc_audit_start.remote(), timeout=30)
        try:
            for i in range(20):
                out = _post(url, {"x": i})
                assert out["ok"] and out["x"] == i
        finally:
            events = ray_tpu_torch.get(proxy.rpc_audit_stop.remote(),
                                       timeout=30)
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"warm compiled ingress made head round trips: {reqs}"
        st = ray_tpu_torch.get(proxy.chain_status.remote(dep), timeout=30)
        assert st["stats"]["dynamic_fallback"] == 0, st["stats"]
    finally:
        serve.delete(dep)


@pytest.mark.chaos
def test_replica_sigkill_under_http_load_never_500s(cluster):
    dep, url, proxy, st0 = _deploy_echo("chaos")
    try:
        gen0 = st0["generation"]
        old_tags = {t for lane in st0["lane_targets"] for _d, t in lane}
        victim_pid = _post(url, {"x": 1})["pid"]

        codes, lock = [], threading.Lock()
        stop = time.monotonic() + 6.0

        def client():
            i = 0
            while time.monotonic() < stop:
                i += 1
                try:
                    code = 200 if _post(url, {"x": i}).get("ok") else -1
                except urllib.error.HTTPError as e:
                    code = e.code
                except Exception:
                    code = -1
                with lock:
                    codes.append(code)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        os.kill(victim_pid, signal.SIGKILL)
        for t in threads:
            t.join(120)
        bad = [c for c in codes if c != 200]
        assert not bad, f"the replica kill surfaced {len(bad)}: {set(bad)}"
        assert len(codes) > 20

        # the lanes recompile and re-spread over the replacement
        deadline = time.time() + 120
        st, new_tags = {}, set()
        while time.time() < deadline:
            st = ray_tpu_torch.get(proxy.chain_status.remote(dep),
                                   timeout=30)
            new_tags = {t for lane in st.get("lane_targets") or []
                        for _d, t in lane}
            if st.get("live") and st["generation"] > gen0 \
                    and len(new_tags) == 2:
                break
            time.sleep(0.5)
        assert st.get("live") and st["generation"] > gen0, st
        assert len(new_tags) == 2, st
        assert len(new_tags - old_tags) == 1 and \
            len(old_tags - new_tags) == 1, (old_tags, new_tags)
        before = st["stats"]["compiled"]
        for i in range(8):
            assert _post(url, {"x": i})["ok"]
        st = ray_tpu_torch.get(proxy.chain_status.remote(dep), timeout=30)
        assert st["stats"]["compiled"] > before, st["stats"]
    finally:
        serve.delete(dep)


# ------------------------------------------------ the LLM app, compiled
ENGINE = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=96,
              kv_blocks=32, kv_block_size=8)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """gpt2-tiny weights larger than its init, so greedy streams vary (as
    tests/test_torch_serve_http.py builds them)."""
    cfg = PG.GPT2Config.preset("gpt2-tiny")
    rng = np.random.default_rng(7)
    flat = {}
    for key, shape in PG.param_shapes(cfg).items():
        matrix = len(shape) - key.startswith("blocks/") == 2
        if key.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        else:
            a = (0.2 if matrix else 0.05) * rng.standard_normal(shape)
        flat[key] = a.astype(np.float32)
    params = PG.params_from_numpy(flat, cfg, device="cpu")
    return PG.save_params(str(tmp_path_factory.mktemp("ckpt")), params, cfg)


def test_compiled_llm_app_matches_jax(cluster, checkpoint):
    app = build_llm_deployment(
        name="cllm", num_replicas=2, model_overrides={"dtype": torch.float32},
        weight_store=False, checkpoint=checkpoint, device="cpu", **ENGINE)
    serve.run(app, route_prefix="/cllm", compiled=True)
    url = f"http://127.0.0.1:{serve.start()}/cllm"
    jsrv = JS.LLMServer(model_overrides={"dtype": jnp.float32},
                        weight_store=False, checkpoint=checkpoint, **ENGINE)
    try:
        bodies = [{"prompt": "hello world", "max_tokens": 8},
                  {"prompt_ids": list(range(5, 40)), "max_tokens": 6},
                  {"prompt": "the quick brown fox", "max_tokens": 5}]
        want = [{k: v for k, v in jsrv(b).items() if k != "id"}
                for b in bodies]
        _post(url, bodies[0])
        proxy = ray_tpu_torch.get_actor("serve-proxy")
        _wait_chain_live(proxy, "cllm")
        got = [{k: v for k, v in _post(url, b).items() if k != "id"}
               for b in bodies]
        assert got == want
        st = ray_tpu_torch.get(proxy.chain_status.remote("cllm"), timeout=30)
        assert st["stats"]["compiled"] >= len(bodies), st["stats"]
    finally:
        jsrv.engine.shutdown()
        serve.delete("cllm")
