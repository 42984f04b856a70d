"""The port's serve control plane (`ray_tpu_torch.serve`) against the JAX
package's.

The mirror of `tests/test_serve.py` (deployments, handle routing, named
methods, multi-replica spread, user_config, `@serve.batch`, replica death
and replacement, status and delete, local testing mode, composition), of
`tests/test_serve_http.py`'s multiplexing case and of the router, admission,
watchdog and autoscaler units of `tests/test_serve_plane.py`, on one
module-scoped runtime. Beside the mirror:

- the pure policy functions run side by side with the JAX package's on the
  same seeded inputs and agree exactly: `calculate_desired_num_replicas`,
  `desired_from_live_load`, `replica_score`, `admission_decision`,
  `prompt_prefix_key`, and the router's choice order (`pick_pow2`, the
  proxy router's prefix affinity) under one random seed;
- `visible_devices` pins a replica to the GPUs it names
  (CUDA_VISIBLE_DEVICES, set before anything in the replica touches CUDA);
- `ReplicaActor.handle_chain` peels trace envelopes, passes upstream error
  markers through and turns a user error into a per-item marker, as the
  JAX replica does.

Deployment classes are defined inside the tests, so they ship by value and
the replicas never import this module (nor JAX).
"""

import asyncio
import random
import time
from collections import OrderedDict

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.serve import autoscaling as JA
from ray_tpu.serve import live_signals as JL
from ray_tpu.serve import proxy as JP
from ray_tpu_torch import serve
from ray_tpu_torch.serve import autoscaling as PA
from ray_tpu_torch.serve import live_signals as PL
from ray_tpu_torch.serve import proxy as PP

TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=16, num_gpus=0, max_workers=24)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _doubler():
    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return 2 * x

        def name(self):
            return "doubler"

    return Doubler


# ------------------------------------------------- pure policy, side by side
def _configs(rng, n):
    out = []
    for _ in range(n):
        kw = dict(min_replicas=int(rng.integers(0, 3)),
                  max_replicas=int(rng.integers(3, 12)),
                  target_ongoing_requests=float(rng.choice([0.5, 1, 2, 4])),
                  upscale_smoothing_factor=float(rng.choice([0.5, 1, 2])),
                  downscale_smoothing_factor=float(rng.choice([0.3, 1])),
                  signal_staleness_s=float(rng.choice([2.0, 10.0])),
                  target_latency_s=float(rng.choice([0.0, 0.2, 1.0])))
        out.append((JA.AutoscalingConfig(**kw), PA.AutoscalingConfig(**kw)))
    return out


def _rows(rng, now, n):
    return [{"queue_depth": int(rng.integers(0, 20)),
             "ewma_latency_s": float(rng.random()),
             "ts": now - float(rng.choice([0.0, 1.0, 5.0, 60.0]))}
            for _ in range(n)]


def test_autoscaling_functions_agree_with_jax():
    rng = np.random.default_rng(0)
    now = 1000.0
    for jcfg, pcfg in _configs(rng, 200):
        for _ in range(5):
            ongoing = float(rng.choice([0, 0.5, 1, 3, 7, 40, 200]))
            current = int(rng.integers(0, 9))
            assert (PA.calculate_desired_num_replicas(pcfg, ongoing, current)
                    == JA.calculate_desired_num_replicas(jcfg, ongoing,
                                                         current))
            rows = _rows(rng, now, int(rng.integers(0, 5)))
            current = int(rng.integers(1, 9))
            assert (PA.desired_from_live_load(pcfg, rows, current, now=now)
                    == JA.desired_from_live_load(jcfg, rows, current,
                                                 now=now))


def test_admission_and_score_agree_with_jax():
    rng = np.random.default_rng(1)
    now = 5000.0
    for _ in range(500):
        slo = dict(slo_s=float(rng.choice([0.0, 0.3, 1.0, 4.0])),
                   max_queue=int(rng.choice([0, 2, 4, 8])),
                   retry_after_s=float(rng.choice([0.5, 1.0, 2.0])))
        replicas = []
        for _ in range(int(rng.integers(1, 5))):
            row = (None if rng.random() < 0.3 else
                   _rows(rng, now, 1)[0])
            replicas.append((int(rng.integers(0, 10)), row))
        max_age = float(rng.choice([2.0, 5.0]))
        assert (PL.admission_decision(PL.SLOConfig(**slo), replicas, now,
                                      max_age)
                == JL.admission_decision(JL.SLOConfig(**slo), replicas, now,
                                         max_age))
        assert (PL.admission_decision(slo, replicas, now, max_age)
                == JL.admission_decision(slo, replicas, now, max_age))
        local, row = replicas[0]
        assert (PL.replica_score(local, row, now, max_age)
                == JL.replica_score(local, row, now, max_age))
        assert PL.ewma_of(row) == JL.ewma_of(row)
    assert PL.as_slo(None) is None and PL.as_slo({"slo_s": 1.0}).slo_s == 1.0
    with pytest.raises(TypeError):
        PL.as_slo(3)


def test_prompt_prefix_key_agrees_with_jax():
    rng = np.random.default_rng(2)
    alphabet = list("abcdefgh é中 ")
    bodies = [None, [], {}, {"prompt": ""}, {"prompt": 3},
              {"messages": "x"}, {"messages": ["not-a-dict"]}]
    for _ in range(200):
        text = "".join(rng.choice(alphabet, size=int(rng.integers(1, 400))))
        bodies.append({"prompt": text})
        bodies.append({"messages": [{"role": "user", "content": text},
                                    {"role": "user", "content": text[:5]}]})
    for body in bodies:
        assert PP.prompt_prefix_key(body) == JP.prompt_prefix_key(body)


class _Live:
    def __init__(self, rows):
        self.rows = rows

    def row(self, dep, tag):
        return self.rows.get(tag)

    async def refresh_async(self, force=False):
        return None


def _bare_router(mod, rows, tags):
    r = mod._AsyncRouter.__new__(mod._AsyncRouter)
    r._deployment = "d"
    r._table = {t: object() for t in tags}
    r._inflight = {t: 0 for t in tags}
    r._model_map = {}
    r._prefix_map = OrderedDict()
    r._live = _Live(rows)
    return r


def test_router_choice_order_agrees_with_jax():
    """Under one random seed both routers pick the same replica sequence:
    pow-2 over live scores (EWMA tiebreak) and prefix affinity with its
    imbalance slack, with local in-flight counts moving between picks."""
    rng = np.random.default_rng(3)
    now = time.time()
    tags = [f"r{i}" for i in range(5)]
    rows = {t: {"queue_depth": int(rng.integers(0, 6)),
                "ewma_latency_s": float(rng.choice([0.1, 0.2])),
                "ts": now - float(rng.choice([0.0, 60.0]))} for t in tags}
    keys = [JP.prompt_prefix_key({"prompt": f"p{i % 7}"}) for i in range(60)]
    picks = {}
    for name, mod in (("jax", JP), ("port", PP)):
        r = _bare_router(mod, rows, tags)
        random.seed(11)
        seq = []
        for i, key in enumerate(keys):
            tag = r._choose(tags, key if i % 3 else None)
            seq.append(tag)
            r._inflight[tag] += 1
            if i % 4 == 3:
                r._inflight[seq[i - 2]] -= 1
        picks[name] = seq
    assert picks["port"] == picks["jax"]
    assert len(set(picks["port"])) >= 2


def test_pick_functions_agree_with_jax():
    rng = np.random.default_rng(4)
    now = 100.0
    for _ in range(100):
        tags = [f"t{i}" for i in range(int(rng.integers(1, 6)))]
        scores = {t: float(rng.integers(0, 4)) for t in tags}
        ewma = {t: float(rng.choice([0.1, 0.2])) for t in tags}
        chain = [f"{i:02x}" for i in range(int(rng.integers(0, 4)))]
        rows = {t: {"ts": now - float(rng.choice([0.0, 30.0])),
                    "prefix_roots": list(rng.choice(
                        ["00", "01", "02", "ff"],
                        size=int(rng.integers(0, 3))))} for t in tags}
        seed = int(rng.integers(0, 1 << 30))
        out = []
        for mod in (JL, PL):
            random.seed(seed)
            out.append((mod.pick_pow2(tags, scores.get, ewma.get),
                        mod.pick_prefix_affinity(tags, chain, rows.get,
                                                 scores.get, now, 5.0)))
        assert out[0] == out[1]


def test_live_signal_routing_prefers_lightly_loaded_replica():
    """The router's pow-2 compares GOSSIPED queue depth (blended with
    local counts): a replica another proxy swamped is avoided even when
    this router never sent it anything; stale gossip falls back to local
    counts."""
    now = time.time()
    r = _bare_router(PP, {
        "r1": {"queue_depth": 12, "ewma_latency_s": 0.2, "ts": now},
        "r2": {"queue_depth": 0, "ewma_latency_s": 0.2, "ts": now}},
        ["r1", "r2"])
    picked = []

    async def fake_submit_on(tag, method, args, kwargs):
        picked.append(tag)
        return "ok"

    async def fake_refresh(force=False):
        return None

    r.submit_on = fake_submit_on
    r._refresh = fake_refresh

    async def drive():
        for _ in range(8):
            await r.submit("__call__", (), {})

    asyncio.run(drive())
    assert set(picked) == {"r2"}, picked
    r._live = _Live({
        "r1": {"queue_depth": 12, "ewma_latency_s": 0.2, "ts": now - 3600},
        "r2": {"queue_depth": 0, "ewma_latency_s": 0.2, "ts": now - 3600}})
    picked.clear()
    asyncio.run(drive())
    assert "r1" in picked and "r2" in picked, picked


def test_prefix_map_evicts_dead_replica_mappings():
    """A prefix->replica mapping whose replica left the route table is
    evicted on refresh, so a dead replica's stale affinity never eats a
    failed first route."""
    table_holder = {"replicas": {"r1": object(), "r2": object()},
                    "models": {}, "slo": None, "version": 1}

    class FakeCtrl:
        class get_routing_table:       # noqa: N801 - mimics handle attr
            @staticmethod
            def remote(dep):
                async def _get():
                    return dict(table_holder)

                return _get()

    r = PP._AsyncRouter(FakeCtrl(), "d")
    r._live = _Live({})
    key = PP.prompt_prefix_key({"prompt": "stick to r1 please"})
    picked = []

    async def fake_submit_on(tag, method, args, kwargs):
        picked.append(tag)
        return "ok"

    r.submit_on = fake_submit_on

    async def drive(n=1):
        for _ in range(n):
            await r.submit("__call__", (), {}, prefix_key=key)

    asyncio.run(drive(4))
    mapped = picked[0]
    assert all(p == mapped for p in picked), picked
    assert r._prefix_map[key] == mapped
    other = "r2" if mapped == "r1" else "r1"
    table_holder["replicas"] = {other: object()}
    r._ts = 0.0
    picked.clear()
    asyncio.run(drive(2))
    assert all(p == other for p in picked), picked
    assert mapped not in r._prefix_map.values()


def test_watchdog_flags_sustained_shedding_unit():
    """The head watchdog flags a route only after sheds persist across
    consecutive passes (one-pass bursts are the bounded queue doing its
    job)."""
    from ray_tpu_torch.core.workload_watchdog import scan

    def fam(total):
        return {"serve_shed_total": [
            ("proxy", {"tags": {"route": "/r", "reason": "slo"},
                       "value": total})]}

    t0 = 1000.0
    kw = dict(slow_pull_s=5.0, straggler_factor=2.0, p99_slo_s=0.0)
    anomalies, st = scan([], fam(5), t0, state=None, **kw)
    assert not [a for a in anomalies if a["anomaly"] == "serve_shedding"]
    anomalies, st = scan([], fam(9), t0 + 40, state=st, **kw)
    assert not [a for a in anomalies if a["anomaly"] == "serve_shedding"]
    anomalies, st = scan([], fam(15), t0 + 80, state=st, **kw)
    shed = [a for a in anomalies if a["anomaly"] == "serve_shedding"]
    assert shed and shed[0]["route"] == "/r"
    assert shed[0]["shed_in_window"] == 6
    anomalies, st = scan([], fam(15), t0 + 120, state=st, **kw)
    assert not [a for a in anomalies if a["anomaly"] == "serve_shedding"]
    anomalies, st = scan([], fam(20), t0 + 160, state=st, **kw)
    assert not [a for a in anomalies if a["anomaly"] == "serve_shedding"]


def test_autoscaler_scales_on_gossiped_live_load_unit():
    cfg = PA.AutoscalingConfig(min_replicas=1, max_replicas=8,
                               target_ongoing_requests=2)
    now = time.time()
    rows = [{"queue_depth": 8, "ewma_latency_s": 0.1, "ts": now},
            {"queue_depth": 8, "ewma_latency_s": 0.1, "ts": now}]
    assert PA.desired_from_live_load(cfg, rows, 2, now=now) == 8
    stale = [{**r, "ts": now - 60} for r in rows]
    assert PA.desired_from_live_load(cfg, stale, 2, now=now) is None
    cfg2 = PA.AutoscalingConfig(min_replicas=1, max_replicas=8,
                                target_ongoing_requests=4,
                                target_latency_s=0.2)
    calm = [{"queue_depth": 2, "ewma_latency_s": 0.9, "ts": now},
            {"queue_depth": 2, "ewma_latency_s": 0.1, "ts": now}]
    assert 2 < PA.desired_from_live_load(cfg2, calm, 2, now=now) <= 8
    idle_slow = [{"queue_depth": 0, "ewma_latency_s": 0.9, "ts": now},
                 {"queue_depth": 0, "ewma_latency_s": 0.9, "ts": now}]
    assert PA.desired_from_live_load(cfg2, idle_slow, 2, now=now) <= 2


def test_autoscaling_formula():
    cfg = PA.AutoscalingConfig(min_replicas=1, max_replicas=10,
                               target_ongoing_requests=2)
    assert PA.calculate_desired_num_replicas(cfg, 8.0, 2) == 4
    assert PA.calculate_desired_num_replicas(cfg, 0.0, 4) == 1
    assert PA.calculate_desired_num_replicas(cfg, 100.0, 2) == 10
    assert PA.calculate_desired_num_replicas(cfg, 4.0, 2) == 2


def test_local_testing_mode():
    """serve.run(..., _local_testing_mode=True) runs the deployment in this
    process with no cluster."""

    @serve.deployment
    class Doubler:
        def __init__(self, bias=0):
            self.bias = bias
            self.cfg = None

        def __call__(self, x):
            return 2 * x + self.bias

        def name(self):
            return "doubler"

        def reconfigure(self, cfg):
            self.cfg = cfg

    h = serve.run(Doubler.bind(bias=1).options(user_config={"k": "v"}),
                  _local_testing_mode=True)
    assert h.remote(20).result() == 41
    assert h.name.remote().result() == "doubler"
    assert h.options(method_name="name").remote().result() == "doubler"
    assert h._inst.cfg == {"k": "v"}

    @serve.deployment
    def plain(x):
        if x < 0:
            raise ValueError("negative")
        return x + 1

    hf = serve.run(plain.bind(), _local_testing_mode=True)
    assert hf.remote(4).result() == 5
    with pytest.raises(ValueError, match="negative"):
        hf.remote(-1).result()


def test_batch_decorator_in_process():
    """`@serve.batch` outside any runtime: concurrent callers share one
    call of the wrapped function; an error fans out to the whole batch."""
    import threading

    class Model:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            self.sizes.append(len(items))
            if any(x < 0 for x in items):
                raise ValueError("negative in batch")
            return [x * 3 for x in items]

    m = Model()
    out, errs = {}, []

    def go(x):
        try:
            out[x] = m(x)
        except ValueError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert out == {i: 3 * i for i in range(4)} and max(m.sizes) >= 2
    threads = [threading.Thread(target=go, args=(x,)) for x in (-1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert errs and all("negative" in e for e in errs)


def test_multiplex_lru_in_process():
    loads = []

    class Owner:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            loads.append(model_id)
            return {"id": model_id}

    o = Owner()
    for mid in ("a", "a", "b", "c", "a"):
        assert o.get_model(mid)["id"] == mid
    assert loads == ["a", "b", "c", "a"]
    from ray_tpu_torch.serve.multiplex import loaded_model_ids_of

    assert loaded_model_ids_of(o) == ["c", "a"]


def test_handle_chain_markers():
    """`ReplicaActor.handle_chain` run in this process (the actor class's
    own methods on a bare instance): envelopes peeled, upstream markers
    passed through, a user error becomes this item's marker only."""
    from ray_tpu_torch.serve import compiled_chain as PC
    from ray_tpu_torch.serve.replica import ReplicaActor

    cls = ReplicaActor._cls   # the class under the actor wrapper

    def fn(x):
        if x == "bad":
            raise ValueError("bad input")
        return x.upper()

    rep = cls("chain-dep", "chain-dep#1", fn, None, None, None)
    upstream = PC.infra_error("upstream died")
    out = rep.handle_chain([PC.TracedValue(None, "a"), "b", upstream, "bad"])
    assert out[:2] == ["A", "B"]
    assert out[2] is upstream
    assert PC.is_chain_error(out[3]) and out[3]["infra"] is False
    rep._draining = True
    drained = rep.handle_chain(["c"])
    assert PC.is_chain_error(drained[0]) and drained[0]["infra"] is True


# ------------------------------------------------------ on the runtime
def test_deploy_and_call(cluster):
    handle = serve.run(_doubler().bind(), name="doubler")
    assert handle.remote(21).result(timeout=TIMEOUT) == 42
    assert handle.name.remote().result(timeout=TIMEOUT) == "doubler"


def test_multi_replica_routing(cluster):
    @serve.deployment
    class WhoAmI:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self):
            return self.pid

    handle = serve.run(WhoAmI.options(num_replicas=3).bind(), name="who")
    pids = {handle.remote().result(timeout=TIMEOUT) for _ in range(30)}
    assert len(pids) >= 2
    serve.delete("who")


def test_user_config_reconfigure(cluster):
    @serve.deployment
    class Threshold:
        def __init__(self):
            self.threshold = 0

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self):
            return self.threshold

    handle = serve.run(
        Threshold.options(user_config={"threshold": 5}).bind(), name="thresh")
    assert handle.remote().result(timeout=TIMEOUT) == 5
    serve.delete("thresh")


def test_batching(cluster):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            return [(x, len(items)) for x in items]

    handle = serve.run(Batched.options(max_ongoing_requests=16).bind(),
                       name="batched")
    responses = [handle.remote(i) for i in range(8)]
    out = [r.result(timeout=TIMEOUT) for r in responses]
    assert sorted(x for x, _ in out) == list(range(8))
    assert max(bs for _, bs in out) >= 2
    serve.delete("batched")


def test_multiplexed_models(cluster):
    @serve.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "weight": len(model_id)}

        def __call__(self, request):
            model_id = serve.get_multiplexed_model_id()
            model = self.get_model(model_id)
            return {"served_by": model["id"], "loads": list(self.loads)}

    h = serve.run(MultiModel.bind(), name="mm")

    def call(mid):
        return h.options(multiplexed_model_id=mid).remote({}).result(
            timeout=TIMEOUT)

    assert call("model-a")["served_by"] == "model-a"
    assert call("model-a")["loads"].count("model-a") == 1
    call("model-b")
    call("model-c")
    assert call("model-a")["loads"].count("model-a") == 2
    serve.delete("mm")


def test_visible_devices_pin_the_replica(cluster):
    """`visible_devices` is per deployment: every replica sees exactly the
    GPUs named (the JAX package's visible_chips); without it a replica
    keeps its process's view."""

    @serve.deployment
    class Env:
        def __call__(self):
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES")

    h = serve.run(Env.options(visible_devices=[1, 3]).bind(), name="pinned")
    assert h.remote().result(timeout=TIMEOUT) == "1,3"
    serve.delete("pinned")
    h = serve.run(Env.bind(), name="unpinned")
    assert h.remote().result(timeout=TIMEOUT) != "1,3"
    serve.delete("unpinned")


def test_replica_death_recovery(cluster):
    @serve.deployment
    class Fragile:
        def __call__(self):
            return "alive"

        def die(self):
            import os

            os.kill(os.getpid(), 9)

    handle = serve.run(Fragile.options(num_replicas=1).bind(), name="fragile")
    assert handle.remote().result(timeout=TIMEOUT) == "alive"
    try:
        handle.die.remote().result(timeout=10)
    except Exception:
        pass
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            if handle.remote().result(timeout=10) == "alive":
                break
        except Exception:
            time.sleep(0.3)
    else:
        pytest.fail("replica was not replaced after death")
    serve.delete("fragile")


def test_status_and_delete(cluster):
    serve.run(_doubler().bind(), name="temp")
    st = serve.status()
    assert "temp" in st and st["temp"]["running"] >= 1
    serve.delete("temp")
    time.sleep(0.3)
    assert "temp" not in serve.status()


def test_deployment_composition(cluster):
    """A bound sub-deployment passed as an init arg deploys first and
    arrives at the parent replica as a live DeploymentHandle."""

    @serve.deployment
    class Featurizer:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Model:
        def __init__(self, featurizer):
            self.featurizer = featurizer

        def __call__(self, x):
            return self.featurizer.remote(x).result(timeout=30) + 1

    handle = serve.run(Model.bind(Featurizer.bind()))
    assert handle.remote(4).result(timeout=TIMEOUT) == 41
    status = serve.status()
    assert "Model" in status and "Featurizer" in status
    serve.delete("Model")
    serve.delete("Featurizer")
