"""The cluster prefix tier in the port (`serve/prefix_store.py`).

The port's mirror of `tests/test_prefix_store.py`'s nine cases, against
`ray_tpu_torch`: prefix bindings ride the gossiped directory (one content
hash a block boundary, the deepest resident binding wins, purged with its
blob or its node); the tenant-tagged counters reach the Prometheus text; a
blob still in flight does not block other lanes; a prefix computed by one
replica warm-starts another with ZERO head RPCs on the warm path; LoRA
adapters share the base model's entries; the owner dying mid-fetch
degrades to a local prefill; bindings survive a head restart through the
publishers' re-announce.

Where the JAX test runs serve deployments (their mirror, with
`DisaggLLMServer`, is in tests/test_torch_serve_disagg.py), the port's runs
plain actors: the cross-replica case uses a `PrefillServer`
actor and an `LLMServer(cluster_prefix_cache=True)` actor, and its tokens
equal the JAX package's `LLMServer` on the same checkpoint; the routing
case holds the prefill replica's advertised prefix roots (what the
router's prefix-affinity pick reads) equal to the JAX package's.
"""

import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import object_directory as objdir
from ray_tpu_torch.core.ids import NodeID, ObjectID
from ray_tpu_torch.core.store import ObjectMeta
from ray_tpu_torch.serve.kv_cache import chain_hashes

# 4 layers so a ~90-token prompt's KV blob (~360 KiB) is past the inline
# threshold: prefix blobs must ride the object data plane
MODEL = dict(preset="gpt2-tiny", max_seq_len=96, seed=7,
             model_overrides={"vocab_size": 512, "attn_impl": "dense",
                              "n_layer": 4},
             kv_blocks=64, kv_block_size=8, device="cpu")
ENGINE_KW = {k: v for k, v in MODEL.items()
             if k not in ("kv_blocks", "kv_block_size")}


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=6, num_gpus=0, max_workers=10)
    yield info
    ray_tpu_torch.shutdown()


def _ids(n, salt=0):
    return [(i * 7 + salt * 131) % 500 + 1 for i in range(n)]


def _meta(node: NodeID, size=1 << 20) -> ObjectMeta:
    m = ObjectMeta(ObjectID.generate(), size, "shm", segment="seg_px")
    m.node_id = node
    return m


# ------------------------------------------------ directory prefix rows
def test_directory_prefix_rows_bind_lookup_purge():
    d = objdir.ObjectDirectory()
    node = NodeID.generate()
    m = _meta(node)
    d.apply({"v": 1, "delta": [objdir.seal_record(m)]})
    chain = chain_hashes(_ids(24), 8)
    d.apply({"v": 2, "delta": [
        objdir.prefix_record("mk", ph, m.object_id, n, 8)
        for ph, n in chain]})
    assert d.prefix_count() == 3
    hit = d.longest_prefix("mk", chain)
    assert hit["n"] == 24 and hit["oid"] == m.object_id.binary()
    assert d.longest_prefix("mk", chain[:1])["n"] == 8
    assert d.longest_prefix("mk", chain_hashes(_ids(24, salt=9), 8)) is None
    assert d.longest_prefix("other-mk", chain) is None
    d.apply({"v": 3, "delta": [objdir.free_record(m.object_id)]})
    assert d.longest_prefix("mk", chain) is None
    assert d.prefix_count() == 0


def test_directory_prefix_residency_check_and_node_death():
    d = objdir.ObjectDirectory()
    node = NodeID.generate()
    chain = chain_hashes(_ids(24), 8)
    shallow = _meta(node)
    d.apply({"v": 1, "delta": [objdir.seal_record(shallow)]})
    ghost = ObjectID.generate()
    d.apply({"v": 2, "delta": [
        objdir.prefix_record("mk", chain[0][0], shallow.object_id, 8, 8),
        objdir.prefix_record("mk", chain[2][0], ghost, 24, 8)]})
    assert d.longest_prefix("mk", chain)["n"] == 8
    d.apply({"v": 3, "delta": [objdir.node_dead_record(node.hex())]})
    assert d.longest_prefix("mk", chain) is None
    d2 = objdir.ObjectDirectory()
    m2 = _meta(NodeID.generate())
    d2.apply({"v": 1, "delta": [objdir.seal_record(m2)]})
    d2.apply({"v": 2, "delta": [
        objdir.prefix_record("mk", chain[1][0], m2.object_id, 16, 8)]})
    d3 = objdir.ObjectDirectory()
    d3.apply(d2.full_payload(7))
    assert d3.longest_prefix("mk", chain)["n"] == 16
    assert d3.last_v == 7


# ------------------------------------------------ prefix-affinity routing
def test_prefill_routing_hint_equals_jax():
    """The resident-prefix hint a prefill replica advertises (the prefix
    roots the router's affinity pick matches against, most recent last)
    is the JAX package's for the same prompts: content hashes of the token
    ids, whatever the weights."""
    from ray_tpu.serve.disagg import PrefillServer as JPrefill
    from ray_tpu_torch.serve.disagg import PrefillServer

    kw = dict(max_batch=2, cluster_prefix_cache=False, **MODEL)
    port = PrefillServer(**kw)
    jkw = {k: v for k, v in kw.items() if k != "device"}
    jax_srv = JPrefill(**jkw)
    try:
        for salt in (0, 1, 2):
            a = port.prefill(_ids(33, salt=salt))
            b = jax_srv.prefill(_ids(33, salt=salt))
            assert a["n_tokens"] == b["n_tokens"] == 32
        hint = port.live_signal_extra()["prefix_roots"]
        assert hint and hint == jax_srv.live_signal_extra()["prefix_roots"]
        assert port.stats()["blobs_exported"] == 3
    finally:
        port.engine.shutdown()
        jax_srv.engine.shutdown()


def test_prefix_store_counters_reach_metrics_exposition():
    from ray_tpu_torch.serve.prefix_store import PrefixStoreClient
    from ray_tpu_torch.util import metrics as m

    store = PrefixStoreClient("mk-metrics", 8)
    assert store.lookup(_ids(16), tenant="adapterX") is None
    text = m.render_prometheus({"proc0": m.snapshot_all()})
    assert "ray_tpu_prefix_store_misses_total" in text
    assert 'tenant="adapterX"' in text


# ------------------------------------------------ async prefill fetch
def test_async_prefix_fetch_overlaps_other_lane_decode():
    from concurrent.futures import Future

    from ray_tpu_torch.serve.llm import LLMEngine

    kw = dict(max_batch=2, kv_blocks=64, kv_block_size=8, **ENGINE_KW)
    donor, eng = LLMEngine(**kw), LLMEngine(**kw)
    try:
        ids = _ids(41)
        want = donor.generate(prompt_ids=ids, max_tokens=6)["token_ids"]
        blob = donor.export_prefix(prompt_ids=ids)
        assert blob is not None and len(blob["ids"]) == 40
        fut = Future()
        result = {}

        def deferred():
            result["out"] = eng.generate(prompt_ids=ids, max_tokens=6,
                                         prefix_future=fut,
                                         prefix_wait_s=60, timeout=120)

        t = threading.Thread(target=deferred, daemon=True)
        t.start()
        other = eng.generate(prompt_ids=_ids(5, salt=3), max_tokens=5,
                             timeout=60)
        assert len(other["token_ids"]) == 5
        assert not result, "deferred request ran before its blob landed"
        assert eng.engine_stats()["deferred"] == 1
        fut.set_result(blob)
        t.join(120)
        assert result["out"]["token_ids"] == want
        st = eng.engine_stats()
        assert st["prefix_imports"] >= 1
        assert st["prefix_blocks_imported"] >= 5
        assert st["tokens_prefilled"] < 40 + 10
        never = Future()
        out = eng.generate(prompt_ids=_ids(30, salt=5), max_tokens=4,
                           prefix_future=never, prefix_wait_s=0.3,
                           timeout=60)
        assert len(out["token_ids"]) == 4
        assert eng.engine_stats()["prefix_wait_timeouts"] >= 1
    finally:
        donor.shutdown()
        eng.shutdown()


# ------------------------------------------- cross-replica warm start
@ray_tpu_torch.remote
class DecodeReplica:
    """An `LLMServer` with the cluster prefix tier, and the audit hooks a
    serve replica would expose."""

    def __init__(self, **kw):
        from ray_tpu_torch.serve.disagg import _RpcAudit
        from ray_tpu_torch.serve.llm import LLMServer

        self.srv = LLMServer(cluster_prefix_cache=True, **kw)
        self.audit = _RpcAudit()

    def probe(self, ids):
        hit = self.srv.prefix_store.lookup(list(ids), count=False)
        return None if hit is None else hit["n"]

    def call(self, body):
        return self.srv(body)

    def audit_start(self):
        return self.audit.start()

    def audit_stop(self):
        return self.audit.stop()

    def stats(self):
        return self.srv.stats()


def test_cross_replica_warm_start_zero_head_rpcs(cluster):
    """A prefix exported by replica A (a prefill actor) warm-starts replica
    B, whose only source is the cluster store, with zero head round trips
    on the warm path (audited inside B); B's tokens equal a monolithic
    engine's and the JAX package's `LLMServer` on the same checkpoint."""
    from ray_tpu.serve.llm import LLMServer as JServer
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.disagg import PrefillServer
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", **{
        **MODEL["model_overrides"], "max_seq_len": 96})
    ckpt = os.path.join(tempfile.mkdtemp(prefix="px_ck_"), "ck")
    gpt2.save_params(ckpt, gpt2.init_params(
        torch.Generator().manual_seed(7), cfg, "cpu"), cfg)
    # the weight plane is not under test here (tests/test_torch_weight_
    # store.py): every engine reads the checkpoint
    kw = {**MODEL, "checkpoint": ckpt, "max_batch": 2, "weight_store": False}
    pre = ray_tpu_torch.remote(PrefillServer).remote(**kw)
    dec = DecodeReplica.remote(**kw)
    ref_eng = LLMEngine(enable_prefix_caching=False, max_batch=2,
                        checkpoint=ckpt, weight_store=False,
                        **{k: v for k, v in ENGINE_KW.items()
                           if k != "seed"})
    jkw = {k: v for k, v in kw.items() if k not in ("device", "seed")}
    jax_srv = JServer(**jkw)
    try:
        ids = _ids(90)
        res = ray_tpu_torch.get(pre.prefill.remote(ids), timeout=240)
        assert res["n_tokens"] == 88
        assert res.get("ref") is not None, "blob rode the inline path"
        deadline = time.time() + 30
        covered = None
        while time.time() < deadline:
            covered = ray_tpu_torch.get(dec.probe.remote(ids[:-1]),
                                        timeout=30)
            if covered:
                break
            time.sleep(0.2)
        assert covered == 88, covered
        assert ray_tpu_torch.get(dec.audit_start.remote(), timeout=30)
        want = ref_eng.generate(prompt_ids=ids, max_tokens=6)["token_ids"]
        out = ray_tpu_torch.get(dec.call.remote(
            {"prompt_ids": ids, "max_tokens": 6}), timeout=240)
        events = ray_tpu_torch.get(dec.audit_stop.remote(), timeout=30)
        got = out["choices"][0]["token_ids"]
        assert got == want, "store-tier warm start diverged"
        assert got == jax_srv({"prompt_ids": ids, "max_tokens": 6})[
            "choices"][0]["token_ids"], "port tokens differ from JAX's"
        reqs = [m for k, m in events if k == "req"]
        assert not reqs, f"head round trips on the warm path: {reqs}"
        st = ray_tpu_torch.get(dec.stats.remote(), timeout=60)
        assert st["prefix_store"]["store_fetches"] >= 1, st
        assert st["prefix_store"]["store_hits"] >= 1, st
        assert st["prefix_blocks_imported"] >= 11, st
    finally:
        ref_eng.shutdown()
        jax_srv.engine.shutdown()
        ray_tpu_torch.kill(pre)
        ray_tpu_torch.kill(dec)


# --------------------------------------------------- multi-tenant LoRA
def test_lora_adapters_share_base_prefix_entries(cluster):
    from ray_tpu_torch.serve.llm import OpenAIServer

    root = tempfile.mkdtemp(prefix="lora_px_")
    L, D = 4, 128
    rng = np.random.default_rng(0)
    for name in ("a1", "a2"):
        np.savez(os.path.join(root, f"{name}.npz"), **{
            "blocks.attn.wqkv.A": (rng.normal(size=(L, D, 4))
                                   * 0.05).astype(np.float32),
            "blocks.attn.wqkv.B": (rng.normal(size=(L, 4, 3 * D))
                                   * 0.05).astype(np.float32)})
    srv = OpenAIServer(model_id="tiny", lora_root=root, max_loras=2,
                       max_batch=2, kv_blocks=64, kv_block_size=8,
                       cluster_prefix_cache=True, **ENGINE_KW)
    try:
        shared = _ids(80)
        srv({"prompt_ids": shared + _ids(4, salt=1), "max_tokens": 3,
             "model": "tiny:a1"})
        deadline = time.time() + 30
        while (time.time() < deadline
               and not srv.prefix_store.stats()["published"]):
            time.sleep(0.05)
        assert srv.prefix_store.stats()["published"] >= 1
        srv({"prompt_ids": shared + _ids(4, salt=2), "max_tokens": 3,
             "model": "tiny:a2"})
        st2 = srv.prefix_store.stats()
        assert st2["hits_by_tenant"].get("a2", 0) >= 1, st2
        deadline = time.time() + 30
        eng2 = srv._lora_engines["a2"]
        while time.time() < deadline and not eng2.prefix_blocks_imported:
            time.sleep(0.1)
        assert eng2.prefix_blocks_imported >= 10
        owners = {srv.prefix_store._pin_rows[ph][0]
                  for ph, _n in chain_hashes(shared, 8)
                  if ph in srv.prefix_store._pin_rows}
        assert len(owners) == 1, f"shared prefix stored {len(owners)} times"
    finally:
        srv.shutdown()


# ------------------------------------------------------- chaos drills
class _Base:
    """A replica-like actor holding a pool with seeded KV and a store."""

    def __init__(self, seed=0):
        from ray_tpu_torch.serve import kv_cache, prefix_store

        self.kv = kv_cache.PagedKVCache(n_layer=4, n_head=4, head_dim=32,
                                        num_blocks=8, block_size=8,
                                        device="cpu")
        g = torch.Generator().manual_seed(seed)
        self.cache = {"k": torch.randn((4, 1, 4, 64, 32), generator=g),
                      "v": torch.randn((4, 1, 4, 64, 32), generator=g)}
        self.store = prefix_store.PrefixStoreClient("drill-model", 8,
                                                    fetch_timeout_s=5.0)

    def publish(self, ids):
        from ray_tpu_torch.serve import kv_cache

        self.kv.store_prefix(list(ids), self.cache, 0)
        blob = kv_cache.export_prefix(self.kv, list(ids))
        return {"ok": self.store.publish(blob), "n": len(blob["ids"])}

    def probe(self, ids):
        hit = self.store.lookup(list(ids))
        return None if hit is None else hit["n"]

    def warm_or_local(self, ids):
        from ray_tpu_torch.serve import kv_cache

        hit = self.store.lookup(list(ids))
        if hit is not None:
            blob = self.store.fetch(hit)
            if blob is not None:
                return {"mode": "store",
                        "blocks": kv_cache.import_prefix(self.kv, blob)}
        return {"mode": "local"}

    def reannounced(self):
        return self.store.reannounced


def _iso_cluster(**kw):
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()   # its own cluster; the fixture's goes first
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    return Cluster(num_cpus=0, **kw)


def _until(fn, seconds, what):
    deadline = time.time() + seconds
    while True:
        try:
            if fn():
                return
        except Exception:
            pass
        assert time.time() < deadline, what
        time.sleep(0.3)


def test_prefix_owner_death_degrades_to_local_prefill(cluster):
    c = _iso_cluster()
    try:
        owner_node = c.add_node(num_cpus=2, resources={"owner_pool": 4})
        c.add_node(num_cpus=2, resources={"consumer_pool": 4})
        c.connect()
        c.wait_for_nodes(3)
        Base = ray_tpu_torch.remote(_Base)
        owner = Base.options(resources={"owner_pool": 1}).remote(seed=3)
        consumer = Base.options(resources={"consumer_pool": 1}).remote(
            seed=99)
        ids = list(range(1, 33))
        pub = ray_tpu_torch.get(owner.publish.remote(ids), timeout=180)
        assert pub["ok"] and pub["n"] == 32
        _until(lambda: ray_tpu_torch.get(consumer.probe.remote(ids),
                                         timeout=60) == 32, 30,
               "binding never reached the consumer node")
        c.kill_node(owner_node)
        out = ray_tpu_torch.get(consumer.warm_or_local.remote(ids),
                                timeout=120)
        assert out["mode"] == "local", out
        _until(lambda: ray_tpu_torch.get(consumer.probe.remote(ids),
                                         timeout=60) is None, 60,
               "dead owner's binding never evicted")
        assert ray_tpu_torch.get(consumer.publish.remote(ids),
                                 timeout=180)["ok"]
        assert ray_tpu_torch.get(consumer.probe.remote(ids), timeout=60) == 32
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
    assert c.processes() == [] and c.segments() == []


def test_prefix_bindings_survive_head_restart_via_reannounce(cluster):
    c = _iso_cluster(enable_snapshots=True)
    try:
        c.add_node(num_cpus=2, resources={"pub_pool": 4})
        c.connect()
        c.wait_for_nodes(2)
        client = ray_tpu_torch.core.api._global_client()
        ids = list(range(1, 33))
        pub = ray_tpu_torch.remote(_Base).options(
            resources={"pub_pool": 1}).remote(seed=5)
        assert ray_tpu_torch.get(pub.publish.remote(ids), timeout=120)["ok"]
        chain = chain_hashes(ids, 8)

        def bound():
            return client.object_dir.longest_prefix("drill-model",
                                                    chain) is not None

        _until(bound, 30, "binding never reached the gossiped directory")
        c.kill_head()
        c.restart_head(restore=True)
        _until(lambda: ray_tpu_torch.get(pub.reannounced.remote(),
                                         timeout=30) >= 1, 90,
               "reconnect hook never re-announced")

        @ray_tpu_torch.remote(resources={"pub_pool": 1})
        class Consumer:
            def probe(self, ids):
                from ray_tpu_torch.core.api import _global_client

                hit = _global_client().object_dir.longest_prefix(
                    "drill-model", chain_hashes(list(ids), 8))
                return None if hit is None else hit["n"]

        consumer = Consumer.remote()
        _until(lambda: ray_tpu_torch.get(consumer.probe.remote(ids),
                                         timeout=30) == 32, 60,
               "a fresh consumer never resolved the full prefix")
        assert bound(), "binding did not survive the head restart"
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
    assert c.processes() == [] and c.segments() == []
