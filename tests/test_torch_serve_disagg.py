"""Disaggregated prefill/decode serving in the port (`serve/disagg.py`:
`DisaggLLMServer`, `build_disagg_llm_deployment`), mirroring
`tests/test_serve_plane.py`'s disaggregation case, KV shipping under
seeded data-edge drops and replica-kill soak, and
`tests/test_prefix_store.py`'s cross-replica warm start on serve
deployments.

The engines serve one seeded float32 checkpoint (gpt2-tiny at 4 layers, so
that a ~90-token prompt's KV blob is past the inline threshold and rides
the object data plane) on the CPU in replica processes; their greedy tokens
equal a monolithic engine's and the JAX package's `LLMServer` called
in-process on the same checkpoint. Warm paths make zero head round trips,
audited inside the replica processes (`rpc_audit_start/stop`).
"""

import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve

MODEL = dict(preset="gpt2-tiny", max_seq_len=96,
             model_overrides={"vocab_size": 512, "attn_impl": "dense",
                              "n_layer": 4},
             kv_blocks=64, kv_block_size=8)
# warm-path head traffic that is permitted: fire-and-forget telemetry,
# object seals and prefix-binding announcements
PUSHES = {"ref_update", "metrics_push", "put_meta", "announce_prefix",
          "blocked"}


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=12, num_gpus=0, max_workers=20)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ckpt():
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", **{
        **MODEL["model_overrides"], "max_seq_len": 96})
    path = os.path.join(tempfile.mkdtemp(prefix="disagg_ck_"), "ck")
    gpt2.save_params(path, gpt2.init_params(
        torch.Generator().manual_seed(7), cfg, "cpu"), cfg)
    return path


def _kw(ckpt) -> dict:
    # the weight plane is not under test here: every engine reads the
    # checkpoint
    return {**MODEL, "checkpoint": ckpt, "weight_store": False,
            "device": "cpu"}


def _references(ckpt):
    """A monolithic port engine and the JAX package's LLMServer on the same
    checkpoint."""
    from ray_tpu.serve.llm import LLMServer as JServer
    from ray_tpu_torch.serve.llm import LLMEngine

    ref = LLMEngine(enable_prefix_caching=False, max_batch=2, **_kw(ckpt))
    jkw = {k: v for k, v in _kw(ckpt).items() if k != "device"}
    return ref, JServer(max_batch=2, **jkw)


def _tokens(out) -> list:
    return out["choices"][0]["token_ids"]


def _post(url: str, body: dict, timeout: float = 60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def _wait_serve_rows(*deployments, timeout: float = 30.0) -> None:
    """Until the head has merged a load row of every named deployment: the
    cluster_view broadcast (every 0.25 s) then carries them to each
    replica, whose router reads them instead of asking the head."""
    from ray_tpu_torch.util import state

    deadline = time.time() + timeout
    while time.time() < deadline:
        seen = {(r.get("stats") or {}).get("deployment")
                for r in state.list_serve_stats(
                    filters=[("kind", "=", "serve_replica")])}
        if set(deployments) <= seen:
            return
        time.sleep(0.2)
    raise AssertionError(f"no load rows of {deployments} at the head")


def _ids(n, salt=0):
    return [(i * 7 + salt * 131) % 500 + 1 for i in range(n)]


def test_disagg_app_asks_for_gpus_and_runs_on_cuda_unless_told():
    """`num_gpus` goes to both pools' replicas (where the JAX package asks
    for chips) and a replica built without `device` runs on CUDA: here,
    with none, its engine raises."""
    from ray_tpu_torch.serve.disagg import (DisaggLLMServer,
                                            build_disagg_llm_deployment)

    app = build_disagg_llm_deployment(name="d", num_gpus=1,
                                      decode_max_batch=3)
    pre = app.init_kwargs["prefill_handle"]
    assert app.name == "d" and pre.name == "d-prefill"
    for dep in (app, pre):
        assert dep.ray_actor_options == {"num_cpus": 1, "num_gpus": 1}
    assert app.max_ongoing_requests == 6
    assert build_disagg_llm_deployment().ray_actor_options == {"num_cpus": 1}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default would succeed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggLLMServer(preset="gpt2-tiny")


def test_disagg_prefill_decode_ships_kv_zero_head_rpcs(cluster, ckpt):
    """The decode pool serves a fresh prompt by pulling the prefill pool's
    exported KV blob over the object data plane: tokens equal a monolithic
    engine's and the JAX package's, over a handle and over HTTP, with zero
    head round trips from either replica on the warm path."""
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment

    app = build_disagg_llm_deployment(name="disagg", prefill_replicas=1,
                                      decode_replicas=1, **_kw(ckpt))
    h = serve.run(app, name="disagg", route_prefix="/disagg")
    pre_h = serve.get_deployment_handle("disagg-prefill")
    prompts = ["disaggregated serving ships kv blocks between pools " * 2,
               "a second, different prompt to prefill remotely please " * 2,
               "and a third one travels over http to the decode pool " * 2]
    ref, jsrv = _references(ckpt)
    try:
        want = [ref.generate(p, max_tokens=6)["token_ids"] for p in prompts]
        assert want == [_tokens(jsrv({"prompt": p, "max_tokens": 6}))
                        for p in prompts], "port tokens differ from JAX's"
        out0 = h.remote({"prompt": prompts[0], "max_tokens": 6}).result(
            timeout=240)
        assert _tokens(out0) == want[0]
        st = h.stats.remote().result(timeout=60)
        assert st["prefill_fetches"] >= 1 and st["blocks_imported"] > 0, st
        assert st["plane_fetches"] >= 1, \
            f"blob rode the inline shortcut, not the data plane: {st}"
        _wait_serve_rows("disagg", "disagg-prefill")
        time.sleep(1.0)   # the rows reach the replicas; stragglers flush

        assert h.rpc_audit_start.remote().result(timeout=30) is True
        assert pre_h.rpc_audit_start.remote().result(timeout=30) is True
        out1 = h.remote({"prompt": prompts[1], "max_tokens": 6}).result(
            timeout=240)
        decode_events = h.rpc_audit_stop.remote().result(timeout=30)
        prefill_events = pre_h.rpc_audit_stop.remote().result(timeout=30)
        assert _tokens(out1) == want[1]
        st2 = h.stats.remote().result(timeout=60)
        assert st2["prefill_fetches"] >= st["prefill_fetches"] + 1, st2
        for name, events in (("decode", decode_events),
                             ("prefill", prefill_events)):
            reqs = [m for k, m in events if k == "req"]
            assert not reqs, f"{name} replica made head round trips: {reqs}"
            pushes = {m for k, m in events if k == "push"}
            assert pushes <= PUSHES, f"{name} replica pushed {pushes}"

        url = f"http://127.0.0.1:{serve.start()}/disagg"
        status, _, out2 = _post(url, {"prompt": prompts[2], "max_tokens": 6},
                                timeout=240)
        assert status == 200 and _tokens(out2) == want[2]
    finally:
        ref.shutdown()
        jsrv.engine.shutdown()
        serve.delete("disagg")
        serve.delete("disagg-prefill")


def test_cross_replica_warm_start_zero_head_rpcs(cluster, ckpt):
    """A prefix exported by a prefill deployment's replica warm-starts a
    decode deployment's replica that has no prefill handle (the cluster
    store is its only source), with zero head round trips on the warm path
    and tokens equal to a monolithic engine's and the JAX package's."""
    from ray_tpu_torch.serve.api import deployment
    from ray_tpu_torch.serve.disagg import DisaggLLMServer, PrefillServer

    pre = deployment(PrefillServer, name="px-prefill", num_replicas=1,
                     ray_actor_options={"num_cpus": 1},
                     max_ongoing_requests=4).bind(max_batch=2, **_kw(ckpt))
    serve.run(pre, name="px-prefill")
    pre_h = serve.get_deployment_handle("px-prefill")
    dec = deployment(DisaggLLMServer, name="px-decode", num_replicas=1,
                     ray_actor_options={"num_cpus": 1},
                     max_ongoing_requests=4).bind(
        prefill_handle=None, max_batch=2, **_kw(ckpt))
    serve.run(dec, name="px-decode")
    h = serve.get_deployment_handle("px-decode")
    ref, jsrv = _references(ckpt)
    try:
        ids = _ids(90)
        res = pre_h.prefill.remote(ids).result(timeout=240)
        assert res["n_tokens"] == 88
        assert res.get("ref") is not None, "blob rode the inline path"
        deadline = time.time() + 30
        covered = None
        while time.time() < deadline:
            covered = h.prefix_store_probe.remote(ids[:-1]).result(timeout=30)
            if covered:
                break
            time.sleep(0.2)
        assert covered == 88, f"binding never reached the decode replica: " \
                              f"{covered}"
        assert h.rpc_audit_start.remote().result(timeout=30) is True
        want = ref.generate(prompt_ids=ids, max_tokens=6)["token_ids"]
        out = h.remote({"prompt_ids": ids, "max_tokens": 6}).result(
            timeout=240)
        events = h.rpc_audit_stop.remote().result(timeout=30)
        assert _tokens(out) == want, "store-tier warm start diverged"
        assert want == _tokens(jsrv({"prompt_ids": ids, "max_tokens": 6}))
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"head round trips on the warm path: {reqs}"
        st = h.stats.remote().result(timeout=60)
        assert st["store_fetches"] >= 1, st
        assert st["blocks_imported"] >= 11, st
        assert st["prefill_fetches"] == 0, st
        assert st["prefix_store"]["store_hits"] >= 1, st
    finally:
        ref.shutdown()
        jsrv.engine.shutdown()
        serve.delete("px-decode")
        serve.delete("px-prefill")


def test_serve_chaos_soak_holds_slo_under_replica_kill(cluster):
    """Sustained load through the HTTP proxy with the autoscaler on; one
    replica arms a seeded chaos self-kill mid-load. The proxy's failover
    and the replacement hold p99 within the route's SLO with no failed
    (non-shed) request."""
    SLO_S = 2.5

    @serve.deployment
    class Target:
        def __call__(self, request):
            time.sleep(0.02)
            return {"ok": True}

        def arm_chaos(self, spec: str) -> int:
            from ray_tpu_torch.core import protocol

            protocol.configure_chaos(spec)
            return os.getpid()

        def pid(self) -> int:
            return os.getpid()

    handle = serve.run(
        Target.options(
            max_ongoing_requests=16,
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=2, max_replicas=4, target_ongoing_requests=4),
            slo_config=serve.SLOConfig(slo_s=SLO_S, max_queue=128,
                                       retry_after_s=1.0)).bind(),
        name="slo-drill", route_prefix="/slo-drill")
    url = f"http://127.0.0.1:{serve.start()}/slo-drill"
    codes, lats = [], []
    lock = threading.Lock()
    stop_at = time.monotonic() + 5.0

    def client():
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            try:
                status, _, _ = _post(url, {"x": 1}, timeout=30)
            except urllib.error.HTTPError as e:
                status = e.code
            except Exception:
                status = -1
            with lock:
                codes.append(status)
                if status == 200:
                    lats.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(1.5)
    victim = handle.arm_chaos.remote("seed=7,kill:*:n=1").result(timeout=30)
    for t in threads:
        t.join(90)
    served, shed = codes.count(200), codes.count(429)
    failed = len(codes) - served - shed
    assert failed == 0, f"{failed} non-shed failures: {set(codes)}"
    assert served >= 100, f"the drill served too little: {served}"
    p99 = float(np.percentile(lats, 99))
    assert p99 <= SLO_S, f"p99 {p99:.3f} s blew the {SLO_S} s SLO"
    deadline = time.time() + 60
    while time.time() < deadline:
        pids = set()
        for _ in range(8):
            try:
                pids.add(handle.pid.remote().result(timeout=10))
            except Exception:
                pass
        if pids and victim not in pids:
            break
        time.sleep(0.5)
    else:
        pytest.fail(f"victim replica {victim} still serving")
    assert serve.status().get("slo-drill", {}).get("running", 0) >= 2
    serve.delete("slo-drill")


def _kv_actors():
    """PagedKVCache actors for the cross-node KV roundtrip (defined here so
    they ship by value)."""
    from ray_tpu_torch.serve import kv_cache

    def _digest(blob):
        import hashlib

        return tuple(hashlib.sha256(np.ascontiguousarray(
            np.asarray(blob[n])).tobytes()).hexdigest() for n in ("k", "v"))

    class _KVBase:
        def __init__(self, seed=0):
            # big enough that the blob (512 KiB) rides the shm store and
            # the data plane, not the inline channel
            self.kv = kv_cache.PagedKVCache(n_layer=4, n_head=4, head_dim=32,
                                            num_blocks=8, block_size=8,
                                            device="cpu")
            rng = np.random.default_rng(seed)
            self.cache = {n: torch.from_numpy(
                rng.normal(size=(4, 1, 4, 64, 32)).astype(np.float32))
                for n in ("k", "v")}

    class Exporter(_KVBase):
        def export(self, ids):
            self.kv.store_prefix(list(ids), self.cache, 0)
            blob = kv_cache.export_prefix(self.kv, list(ids))
            checksum = _digest(blob)
            return {"ref": ray_tpu_torch.put(blob), "n": len(blob["ids"]),
                    "checksum": checksum}

    class Importer(_KVBase):
        def install(self, box):
            blob = ray_tpu_torch.get(box["ref"], timeout=120)
            checksum = _digest(blob)
            return {"installed": kv_cache.import_prefix(self.kv, blob),
                    "checksum": checksum}

        def match_len(self, ids):
            return self.kv.peek_prefix_len(list(ids))

    return Exporter, Importer


@pytest.mark.chaos
def test_kv_ship_survives_seeded_data_edge_drops(cluster):
    """The prefill-to-decode blob pull rides the node pull managers' chunk
    retry: seeded drops on the consumer's data edges neither corrupt nor
    lose the KV blob. Runs last: it needs a multi-node cluster of its own
    with chaos and store isolation, so the module's runtime goes first."""
    from ray_tpu_torch.cluster_utils import Cluster

    serve.shutdown()
    ray_tpu_torch.shutdown()
    chaos = "seed=11,drop:fetch_chunk@data-*:every=3"
    saved = os.environ.get("RAY_TPU_STORE_ISOLATION")
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = Cluster(num_cpus=0)
    c.add_node(num_cpus=2, resources={"prefill_pool": 4})
    c.add_node(num_cpus=2, resources={"decode_pool": 4},
               env={"RAY_TPU_CHAOS": chaos})
    try:
        c.connect()
        c.wait_for_nodes(3)
        Exporter, Importer = _kv_actors()
        exp = ray_tpu_torch.remote(Exporter).options(
            resources={"prefill_pool": 1}).remote(seed=3)
        imp = ray_tpu_torch.remote(Importer).options(
            resources={"decode_pool": 1}).remote(seed=99)
        ids = list(range(1, 33))                     # 4 full blocks
        box = ray_tpu_torch.get(exp.export.remote(ids), timeout=180)
        out = ray_tpu_torch.get(imp.install.remote(box), timeout=180)
        assert out["installed"] == 4
        assert out["checksum"] == box["checksum"], \
            "the chunk-retried blob diverged under seeded drops"
        assert ray_tpu_torch.get(imp.match_len.remote(ids), timeout=60) == 32
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        c.shutdown()
        if saved is None:
            os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
        else:
            os.environ["RAY_TPU_STORE_ISOLATION"] = saved
    assert c.processes() == [] and c.segments() == []
