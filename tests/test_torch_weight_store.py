"""The weight plane in the port (`serve/weight_store.py`).

The port's mirror of `tests/test_weight_store.py`'s ten cases, against
`ray_tpu_torch`: weights bindings ride the gossiped directory
(residency-checked, purged with their blob); a published tree round-trips
bitwise through the store's `WindowedReader`s and through the streaming
`load_params` off a PEER process (peak host bytes within max_in_flight x
chunk_bytes); `train/checkpoint.open_sharded` windows equal the store's;
LoRA adapter deltas hot-swap byte-identically; a cold `LLMEngine` pulls
its checkpoint's weights with ZERO head RPCs; and the segment owner dying
mid-stream degrades to the checkpoint-path read.

Beside the mirror, the cross-package case: the JAX package's
`publish_params` and the port's pack the same seeded `gpt2-tiny` tree
into byte-equal streams with equal manifests (apart from object ids), and
each package's `load_params` restores the other's stream bit-equal.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import object_directory as objdir
from ray_tpu_torch.core.ids import NodeID, ObjectID
from ray_tpu_torch.core.store import ObjectMeta

# small but comfortably past the inline threshold (~1.2 MB tree), dense
# attention on the CPU
MODEL_OVERRIDES = {"vocab_size": 512, "attn_impl": "dense"}


def _meta(node: NodeID, size=1 << 20) -> ObjectMeta:
    m = ObjectMeta(ObjectID.generate(), size, "shm", segment="seg_w")
    m.node_id = node
    return m


def _leaf_bits(params) -> list:
    from ray_tpu_torch.serve.weight_store import _host_array, \
        _tree_flatten_keyed

    return [(k, _host_array(v).tobytes())
            for k, v in _tree_flatten_keyed(params)]


# ----------------------------------------------------- across packages
def _jax_tree():
    import jax

    from ray_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                  **MODEL_OVERRIDES)
    return jgpt2.init_params(jax.random.key(7), cfg), cfg


def _stream_of(pkg, store, manifest):
    """The segments' bytes of a publication, in stream order."""
    from importlib import import_module

    ids = import_module(f"{pkg.__name__}.core.ids")
    ref_mod = import_module(f"{pkg.__name__}.core.object_ref")
    return b"".join(pkg.get(ref_mod.ObjectRef(ids.ObjectID(s["oid"])),
                            timeout=60) for s in manifest["segments"])


def _reseal(pkg, ws_mod, manifest, stream, weights_id):
    """Seal another package's stream in `pkg`'s runtime as raw-bytes
    segments at the same offsets and announce its manifest (object ids
    replaced) under `weights_id`: the stream restores as that package
    packed it."""
    store = ws_mod.get_store()
    segs, refs = [], []
    for s in manifest["segments"]:
        ref = pkg.put(stream[s["off"]:s["off"] + s["nbytes"]])
        refs.append(ref)
        segs.append({**s, "oid": ref.id.binary()})
    m = {**manifest, "segments": segs, "weights_id": weights_id}
    blob = store._put_blob(m)
    from importlib import import_module

    client = import_module(f"{pkg.__name__}.core.api")._global_client()
    client.head_push("announce_weights", weights_id=weights_id,
                     oid=blob.id.binary())
    deadline = time.time() + 30
    while time.time() < deadline and store.resolve(weights_id) is None:
        time.sleep(0.1)
    assert store.resolve(weights_id) is not None
    return refs, blob


def test_streams_equal_and_restore_across_packages():
    import jax

    import ray_tpu
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.serve import weight_store as jws
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import weight_store as ws

    jtree, jcfg = _jax_tree()
    arch = {k: getattr(jcfg, k) for k in jgpt2._CFG_FIELDS}
    flat = {k: np.asarray(v) for k, v in
            ws._tree_flatten_keyed(jax.tree_util.tree_map(np.asarray, jtree))}
    cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                 **MODEL_OVERRIDES)
    ptree = gpt2.params_from_numpy(flat, cfg, device="cpu")
    want = [(k, v.tobytes()) for k, v in flat.items()]

    # the port packs its tree
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    try:
        pm = ws.get_store().publish_params(ptree, "x/tiny", arch=arch)
        assert pm is not None, ws.get_store().stats()
        pstream = _stream_of(ray_tpu_torch, ws.get_store(), pm)
    finally:
        ray_tpu_torch.shutdown()

    # the JAX package packs the same tree; then restores the port's stream
    ray_tpu.init(num_cpus=2, num_tpu_chips=0, max_workers=4)
    try:
        jm = jws.get_store().publish_params(jtree, "x/tiny", arch=arch)
        assert jm is not None
        jstream = _stream_of(ray_tpu, jws.get_store(), jm)
        assert jstream == pstream, "the two packages' streams differ"
        strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                           if k != "segments"}
        assert strip(jm) == strip(pm)
        assert [(s["off"], s["nbytes"]) for s in jm["segments"]] == \
            [(s["off"], s["nbytes"]) for s in pm["segments"]]
        keep = _reseal(ray_tpu, jws, pm, pstream, "x/from-port")
        loaded = jws.get_store().load_params("x/from-port", base_cfg=jcfg)
        assert loaded is not None, jws.get_store().stats()
        got = [(k, np.asarray(v).tobytes()) for k, v in
               ws._tree_flatten_keyed(jax.tree_util.tree_map(
                   np.asarray, loaded[0]))]
        assert got == want, "JAX restored the port's stream differently"
        del keep
    finally:
        ray_tpu.shutdown()

    # the port restores the JAX package's stream
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    try:
        keep = _reseal(ray_tpu_torch, ws, jm, jstream, "x/from-jax")
        loaded = ws.get_store().load_params("x/from-jax", base_cfg=cfg,
                                            device="cpu")
        assert loaded is not None, ws.get_store().stats()
        assert _leaf_bits(loaded[0]) == want, \
            "the port restored the JAX stream differently"
        assert loaded[1].n_layer == jcfg.n_layer
        del keep
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------ directory weights rows
def test_directory_weights_rows_bind_lookup_purge():
    d = objdir.ObjectDirectory()
    node = NodeID.generate()
    m1, m2 = _meta(node), _meta(node)
    d.apply({"v": 1, "delta": [objdir.seal_record(m1),
                               objdir.seal_record(m2)]})
    d.apply({"v": 2, "delta": [objdir.weights_record("ck/a", m1.object_id)]})
    assert d.weights_count() == 1
    assert d.weights_binding("ck/a")["oid"] == m1.object_id.binary()
    assert d.weights_binding("ck/other") is None
    d.apply({"v": 3, "delta": [objdir.weights_record("ck/a", m2.object_id)]})
    assert d.weights_binding("ck/a")["oid"] == m2.object_id.binary()
    assert d.weights_count() == 1
    d.apply({"v": 4, "delta": [objdir.free_record(m1.object_id)]})
    assert d.weights_binding("ck/a")["oid"] == m2.object_id.binary()
    d.apply({"v": 5, "delta": [objdir.free_record(m2.object_id)]})
    assert d.weights_binding("ck/a") is None
    assert d.weights_count() == 0
    m3 = _meta(node)
    d.apply({"v": 6, "delta": [objdir.seal_record(m3),
                               objdir.weights_record("ck/b", m3.object_id)]})
    assert d.weights_binding("ck/b") is not None
    d.apply({"v": 7, "delta": [objdir.weights_gone_record("ck/b")]})
    assert d.weights_binding("ck/b") is None


def test_directory_weights_residency_node_death_and_resync():
    d = objdir.ObjectDirectory()
    node = NodeID.generate()
    m = _meta(node)
    d.apply({"v": 1, "delta": [objdir.seal_record(m)]})
    ghost = ObjectID.generate()
    d.apply({"v": 2, "delta": [objdir.weights_record("ck/live", m.object_id),
                               objdir.weights_record("ck/ghost", ghost)]})
    assert d.weights_binding("ck/live") is not None
    assert d.weights_binding("ck/ghost") is None
    d2 = objdir.ObjectDirectory()
    d2.apply(d.full_payload(9))
    assert d2.weights_binding("ck/live")["oid"] == m.object_id.binary()
    d.apply({"v": 3, "delta": [objdir.node_dead_record(node.hex())]})
    assert d.weights_binding("ck/live") is None
    assert d.weights_binding("ck/ghost") is None


# --------------------------------------------------------- cluster tier
@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=6, num_gpus=0, max_workers=10)
    yield info
    ray_tpu_torch.shutdown()


def _tiny_tree(seed=0, mb=1.5):
    rng = np.random.default_rng(seed)
    rows = int(mb * 1e6 / 4 / 256 / 3)
    return {f"layer{i}/w": rng.normal(size=(rows, 256)).astype(np.float32)
            for i in range(3)}


def test_publish_open_windows_bitwise(cluster):
    from ray_tpu_torch.serve import weight_store as ws

    store = ws.get_store()
    assert store is not None
    tree = _tiny_tree(seed=1)
    tree["scale"] = np.float32(0.25)
    tree["layer1/w"] = torch.from_numpy(tree["layer1/w"])   # a tensor leaf
    manifest = store.publish_params(tree, "wid/open-test")
    assert manifest is not None, store.stats()
    assert manifest["total_bytes"] > 1 << 20
    opened = store.open("wid/open-test")
    assert opened is not None
    readers, got_manifest = opened
    assert got_manifest["hash"] == manifest["hash"]
    for key, arr in tree.items():
        arr = np.asarray(arr)
        r = readers[key]
        assert tuple(r.shape) == arr.shape
        if not arr.shape:
            assert r.read(()).tobytes() == arr.tobytes()
            continue
        full = tuple((0, s) for s in arr.shape)
        assert r.read(full).tobytes() == arr.tobytes()
        win = ((3, 7),) + full[1:]
        assert r.read(win).tobytes() == arr[3:7].tobytes()


def test_sub_inline_tree_skips_publication(cluster):
    from ray_tpu_torch.serve import weight_store as ws

    store = ws.get_store()
    before = store.stats()["inline_skipped"]
    assert store.publish_params({"w": np.ones((8, 8), np.float32)},
                                "wid/tiny") is None
    assert store.stats()["inline_skipped"] == before + 1
    assert store.resolve("wid/tiny") is None


def test_load_params_from_peer_bounded_host_bytes(cluster):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import weight_store as ws

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                 **MODEL_OVERRIDES)
    arch = {k: getattr(cfg, k) for k in gpt2._CFG_FIELDS}

    @ray_tpu_torch.remote
    class Publisher:
        def publish(self, arch):
            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.serve import weight_store as ws

            cfg = gpt2.GPT2Config(**arch)
            params = gpt2.init_params(torch.Generator().manual_seed(7), cfg,
                                      "cpu")
            m = ws.get_store().publish_params(params, "wid/peer-load",
                                              arch=arch)
            return m is not None, _leaf_bits(params)

    pub = Publisher.remote()
    ok, want = ray_tpu_torch.get(pub.publish.remote(arch), timeout=180)
    assert ok
    store = ws.get_store()
    deadline = time.time() + 30
    while time.time() < deadline and store.resolve("wid/peer-load") is None:
        time.sleep(0.2)
    assert store.resolve("wid/peer-load") is not None
    loaded = store.load_params("wid/peer-load", base_cfg=cfg, device="cpu")
    assert loaded is not None, store.stats()
    params, got_cfg = loaded
    assert got_cfg.n_layer == cfg.n_layer
    assert _leaf_bits(params) == want, "streamed restore diverged"
    st = store.last_load_stats
    assert 0 < st["peak_host_bytes"] <= st["max_in_flight"] * \
        st["chunk_bytes"], st
    assert store.stats()["store_hits"] >= 1
    ray_tpu_torch.kill(pub)


def test_load_params_rows_larger_than_a_chunk_stay_within_budget(cluster):
    """Each leaf streams as its flat byte range: with chunks smaller than a
    stacked leaf's row (gpt2-tiny's [2, 128, 512] `mlp/wi` has 256 KiB
    rows; 64 KiB chunks here, as GPT-2-125M's 9 MiB rows against the
    default 1 MiB), peak host bytes stay within max_in_flight x
    chunk_bytes and the restore is bit-equal."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import weight_store as ws

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                 **MODEL_OVERRIDES)
    params = gpt2.init_params(torch.Generator().manual_seed(8), cfg, "cpu")
    store = ws.get_store()
    arch = {k: getattr(cfg, k) for k in gpt2._CFG_FIELDS}
    assert store.publish_params(params, "wid/small-chunks",
                                arch=arch) is not None
    saved = store.stream_chunk_bytes
    store.stream_chunk_bytes = 64 << 10
    try:
        loaded = store.load_params("wid/small-chunks", base_cfg=cfg,
                                   device="cpu")
    finally:
        store.stream_chunk_bytes = saved
    assert loaded is not None and _leaf_bits(loaded[0]) == \
        _leaf_bits(params)
    st = store.last_load_stats
    assert st["chunk_bytes"] == 64 << 10
    row = 128 * 512 * 4
    assert st["chunk_bytes"] < row
    assert 0 < st["peak_host_bytes"] <= st["max_in_flight"] * \
        st["chunk_bytes"], st


def test_open_sharded_windows_match_store_windows(cluster):
    from ray_tpu_torch.serve import weight_store as ws
    from ray_tpu_torch.train.checkpoint import open_sharded, save_sharded

    tree = {k: torch.from_numpy(v) for k, v in _tiny_tree(seed=3).items()}
    path = os.path.join(tempfile.mkdtemp(prefix="ws_shard_"), "ck")
    save_sharded(tree, path)
    store = ws.get_store()
    assert store.publish_sharded(path, weights_id="wid/sharded") is not None
    local_readers, _ = open_sharded(path)
    store_readers, _ = store.open("wid/sharded")
    assert set(store_readers) == set(local_readers)
    for key, lr in local_readers.items():
        sr = store_readers[key]
        full = tuple((0, s) for s in lr.shape)
        assert sr.read(full).tobytes() == lr.read(full).tobytes()
        rows = lr.shape[0]
        win = ((rows // 3, max(rows // 3 + 2, rows // 2)),) + full[1:]
        assert sr.read(win).tobytes() == lr.read(win).tobytes(), key


def test_adapter_publish_fetch_cross_process(cluster):
    from ray_tpu_torch.serve import weight_store as ws

    rng = np.random.default_rng(5)
    adapter = {"blocks.attn.wqkv": {
        "A": rng.normal(size=(2, 128, 4)).astype(np.float32),
        "B": rng.normal(size=(2, 4, 384)).astype(np.float32),
        "alpha": 8.0}}
    akey = ws.adapter_store_key("ck/base", "a1")
    assert ws.get_store().publish_adapter(akey, adapter) is not None

    @ray_tpu_torch.remote
    def fetch(akey):
        from ray_tpu_torch.serve import weight_store as ws

        store = ws.get_store()
        deadline = time.time() + 30
        while time.time() < deadline:
            got = store.fetch_adapter(akey, tenant="a1")
            if got is not None:
                return ({p: {k: (np.asarray(v).tobytes()
                                 if k in ("A", "B") else v)
                             for k, v in spec.items()}
                         for p, spec in got.items()}, store.stats())
            time.sleep(0.2)
        return None, store.stats()

    got, stats = ray_tpu_torch.get(fetch.remote(akey), timeout=120)
    assert got is not None, stats
    for p, spec in adapter.items():
        for k, v in spec.items():
            assert got[p][k] == (np.asarray(v).tobytes()
                                 if k in ("A", "B") else v)
    assert stats["store_hits"] >= 1 and stats["store_bytes_fetched"] > 0


# ------------------------------------------------- cold engine, zero RPCs
def test_cold_engine_zero_head_rpcs(cluster):
    """A cold LLMEngine whose checkpoint is on the weight plane pulls its
    params from a peer with ZERO head round trips (audited inside the
    loading process), bitwise-equal to the checkpoint, source "p2p"; the
    first engine read the checkpoint and published it."""
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                 **MODEL_OVERRIDES)
    params = gpt2.init_params(torch.Generator().manual_seed(11), cfg, "cpu")
    ckpt = os.path.join(tempfile.mkdtemp(prefix="ws_cold_"), "ck")
    gpt2.save_params(ckpt, params, cfg)
    want = _leaf_bits(params)
    kw = dict(checkpoint=ckpt, max_seq_len=96,
              model_overrides=dict(MODEL_OVERRIDES),
              enable_prefix_caching=False, max_batch=2, kv_blocks=16,
              kv_block_size=8, device="cpu")

    @ray_tpu_torch.remote
    class Replica:
        def wait_binding(self, ckpt):
            from ray_tpu_torch.serve import weight_store as ws

            deadline = time.time() + 30
            while time.time() < deadline:
                if ws.get_store().resolve(ckpt) is not None:
                    return True
                time.sleep(0.2)
            return False

        def start(self, kw, audit):
            from ray_tpu_torch.serve import weight_store as ws
            from ray_tpu_torch.serve.disagg import _RpcAudit
            from ray_tpu_torch.serve.llm import LLMEngine

            rpc = _RpcAudit()
            if audit:
                assert rpc.start()
            eng = LLMEngine(**kw)
            events = rpc.stop()
            out = {"reqs": [m for k, m in events if k == "req"],
                   "leaves": _leaf_bits(eng.params),
                   "source": eng.weights_source,
                   "stats": ws.get_store().stats()}
            eng.shutdown()
            return out

    first = Replica.remote()
    out1 = ray_tpu_torch.get(first.start.remote(kw, False), timeout=300)
    assert out1["source"] == "checkpoint" and out1["leaves"] == want
    cold = Replica.remote()
    assert ray_tpu_torch.get(cold.wait_binding.remote(ckpt), timeout=60), \
        "the first engine's publication never reached the directory"
    out = ray_tpu_torch.get(cold.start.remote(kw, True), timeout=300)
    assert out["source"] == "p2p", out["stats"]
    assert out["stats"]["store_hits"] >= 1
    assert out["leaves"] == want, "P2P cold start diverged from checkpoint"
    assert not out["reqs"], f"head round trips on the warm path: {out['reqs']}"
    ray_tpu_torch.kill(first)
    ray_tpu_torch.kill(cold)


def test_lora_hot_swap_byte_identical(cluster):
    """An adapter hot-swapped from the weight plane (the second server's
    lora_root does not exist, so the store is its only source) merges into
    params byte-identical to the locally-loaded npz."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import OpenAIServer

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                 **MODEL_OVERRIDES)
    params = gpt2.init_params(torch.Generator().manual_seed(13), cfg, "cpu")
    ckpt = os.path.join(tempfile.mkdtemp(prefix="ws_lora_"), "ck")
    gpt2.save_params(ckpt, params, cfg)
    root = tempfile.mkdtemp(prefix="ws_lora_root_")
    rng = np.random.default_rng(17)
    L, D = cfg.n_layer, cfg.d_model
    np.savez(os.path.join(root, "a1.npz"), **{
        "blocks.attn.wqkv.A": (rng.normal(size=(L, D, 4))
                               * 0.05).astype(np.float32),
        "blocks.attn.wqkv.B": (rng.normal(size=(L, 4, 3 * D))
                               * 0.05).astype(np.float32)})
    kw = dict(checkpoint=ckpt, max_seq_len=96,
              model_overrides=dict(MODEL_OVERRIDES), max_batch=2,
              kv_blocks=16, kv_block_size=8, cluster_prefix_cache=False,
              enable_prefix_caching=False, device="cpu")
    srv1 = OpenAIServer(model_id="tiny", lora_root=root, **kw)
    srv2 = None
    try:
        body = {"prompt_ids": [1, 2, 3, 4], "max_tokens": 2,
                "model": "tiny:a1"}
        srv1(body)
        srv2 = OpenAIServer(model_id="tiny",
                            lora_root="/nonexistent-lora-root", **kw)
        assert srv2(body)["choices"]
        e1, e2 = srv1._lora_engines["a1"], srv2._lora_engines["a1"]
        assert _leaf_bits(e1.params) == _leaf_bits(e2.params)
    finally:
        srv1.shutdown()
        if srv2 is not None:
            srv2.shutdown()


# ------------------------------------------------------- chaos drill
def test_weight_owner_death_mid_stream_falls_back(cluster):
    """The node owning the weight segments is killed between stream
    windows: the consumer's restore degrades to a miss (not a hang, not
    made-up data), and a cold LLMEngine on the consumer node still comes
    up through the checkpoint-path read."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models import gpt2

    ray_tpu_torch.shutdown()   # its own cluster; the fixture's goes first
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = Cluster(num_cpus=0)
    try:
        owner_node = c.add_node(num_cpus=2, resources={"owner_pool": 4})
        c.add_node(num_cpus=2, resources={"consumer_pool": 4})
        cfg = gpt2.GPT2Config.preset("gpt2-tiny", max_seq_len=96,
                                     **MODEL_OVERRIDES)
        params = gpt2.init_params(torch.Generator().manual_seed(23), cfg,
                                  "cpu")
        ckpt = os.path.join(tempfile.mkdtemp(prefix="ws_chaos_"), "ck")
        gpt2.save_params(ckpt, params, cfg)
        want = _leaf_bits(params)
        c.connect()
        c.wait_for_nodes(3)

        class Peer:
            def publish(self, ckpt):
                from ray_tpu_torch.models import gpt2
                from ray_tpu_torch.serve import weight_store as ws

                params, cfg = gpt2.load_params(ckpt, device="cpu")
                return ws.get_store().publish_params(
                    params, ckpt, arch={k: getattr(cfg, k)
                                        for k in gpt2._CFG_FIELDS}) \
                    is not None

            def probe(self, ckpt):
                from ray_tpu_torch.serve import weight_store as ws

                return ws.get_store().resolve(ckpt) is not None

            def read_first_window(self, ckpt):
                from ray_tpu_torch.serve import weight_store as ws

                readers, _m = ws.get_store().open(ckpt)
                r = readers[sorted(readers)[0]]
                win = ((0, min(2, r.shape[0])),) + tuple(
                    (0, s) for s in r.shape[1:])
                return len(r.read(win).tobytes())

            def cold_engine_after_owner_death(self, ckpt):
                from ray_tpu_torch.serve import weight_store as ws
                from ray_tpu_torch.serve.llm import LLMEngine

                store = ws.get_store()
                store.fetch_timeout_s = 5.0        # keep the drill brisk
                before = store.stats()
                loaded = store.load_params(ckpt, device="cpu")
                after = store.stats()
                eng = LLMEngine(checkpoint=ckpt, max_seq_len=96,
                                model_overrides=dict(MODEL_OVERRIDES),
                                enable_prefix_caching=False, max_batch=2,
                                kv_blocks=16, kv_block_size=8, device="cpu")
                out = {"p2p_load": loaded is not None,
                       "misses": after["store_misses"]
                       - before["store_misses"],
                       "source": eng.weights_source,
                       "leaves": _leaf_bits(eng.params)}
                eng.shutdown()
                return out

        owner = ray_tpu_torch.remote(Peer).options(
            resources={"owner_pool": 1}).remote()
        consumer = ray_tpu_torch.remote(Peer).options(
            resources={"consumer_pool": 1}).remote()
        assert ray_tpu_torch.get(owner.publish.remote(ckpt), timeout=300)
        deadline = time.time() + 30
        while not ray_tpu_torch.get(consumer.probe.remote(ckpt), timeout=60):
            assert time.time() < deadline, "binding never reached consumer"
            time.sleep(0.2)
        assert ray_tpu_torch.get(consumer.read_first_window.remote(ckpt),
                                 timeout=120) > 0
        c.kill_node(owner_node)
        out = ray_tpu_torch.get(
            consumer.cold_engine_after_owner_death.remote(ckpt), timeout=300)
        assert out["p2p_load"] is False
        assert out["misses"] >= 1, out
        assert out["source"] == "checkpoint" and out["leaves"] == want
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
    assert c.processes() == [] and c.segments() == []
