"""ray_tpu_torch.serve (kv_cache, llm) against the JAX package.

The engines of both packages serve the same weights in float32 (JAX:
params_override + model_overrides={"dtype": float32}, as
tests/test_serve_llm_kv.py runs it); their greedy token streams must be
identical, for both schedulers, with and without prefix caching.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.serve import kv_cache as JK
from ray_tpu.serve import llm as JS
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve import kv_cache as PK
from ray_tpu_torch.serve import llm as PS


def test_plan_chunk_budget_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 9))
        pending = rng.integers(0, 40, n).tolist()
        decoding = (rng.random(n) < 0.4).tolist()
        chunk, budget = int(rng.integers(1, 33)), int(rng.integers(0, 64))
        assert PS.plan_chunk_budget(pending, decoding, chunk, budget) == \
            JS.plan_chunk_budget(pending, decoding, chunk, budget)


def test_chain_hashes_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        ids = rng.integers(0, 50304, int(rng.integers(0, 100))).tolist()
        bs = int(rng.integers(1, 20))
        assert PK.chain_hashes(ids, bs) == JK.chain_hashes(ids, bs)


def _fake_cache(B=2, T=32, L=2, H=2, Dh=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, B, H, T, Dh), dtype=np.float32),
            rng.standard_normal((L, B, H, T, Dh), dtype=np.float32))


def _kv_pair(num_blocks=8, block_size=4):
    return (JK.PagedKVCache(2, 2, 4, num_blocks=num_blocks,
                            block_size=block_size),
            PK.PagedKVCache(2, 2, 4, num_blocks=num_blocks,
                            block_size=block_size, device="cpu"))


def test_kv_cache_ops_match_jax():
    """One script of stores, matches, evictions and copies on both pools:
    same return values, same stats, same bytes."""
    jkv, pkv = _kv_pair(num_blocks=3, block_size=4)
    ck, cv = _fake_cache(T=64)
    jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    pc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    script = [("store", list(range(11)), 0), ("match", list(range(11))),
              ("store", [1, 2, 3, 4, 9, 9, 9, 9], 1),   # evicts one block
              ("match", [1, 2, 3, 4, 9, 9, 9, 9, 5]),
              ("peek", list(range(12))), ("match", [7, 7]),
              ("store", [50, 51, 52, 53], 1), ("match", [50, 51, 52, 53, 1])]
    for op, ids, *slot in script:
        if op == "store":
            assert pkv.store_prefix(ids, pc, slot[0]) == \
                jkv.store_prefix(ids, jc, slot[0])
        elif op == "peek":
            assert pkv.peek_prefix_len(ids) == jkv.peek_prefix_len(ids)
        else:
            assert pkv.match_prefix(ids) == jkv.match_prefix(ids)
        assert pkv.stats() == jkv.stats()
    np.testing.assert_array_equal(pkv.pool_k.numpy(), np.asarray(jkv.pool_k))
    np.testing.assert_array_equal(pkv.pool_v.numpy(), np.asarray(jkv.pool_v))
    _, blocks = jkv.match_prefix([50, 51, 52, 53])
    assert pkv.match_prefix([50, 51, 52, 53])[1] == blocks
    jout = jkv.copy_into_slot({k: jnp.zeros_like(v) for k, v in jc.items()},
                              0, blocks)
    pout = pkv.copy_into_slot({k: torch.zeros_like(v) for k, v in pc.items()},
                              0, blocks)
    for name in ("k", "v"):
        np.testing.assert_array_equal(pout[name].numpy(),
                                      np.asarray(jout[name]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prefix_blob_crosses_packages(direction):
    jkv, pkv = _kv_pair()
    ck, cv = _fake_cache()
    ids = list(range(11))
    if direction == "jax_to_port":
        src, dst = jkv, pkv
        src.store_prefix(ids, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, 1)
        blob = JK.export_prefix(src, ids)
        assert PK.import_prefix(dst, blob) == 2
        got = dst.pool_k[:, dst.match_prefix(ids)[1]].numpy()
    else:
        src, dst = pkv, jkv
        src.store_prefix(ids, {"k": torch.from_numpy(ck),
                               "v": torch.from_numpy(cv)}, 1)
        blob = PK.export_prefix(src, ids)
        assert JK.import_prefix(dst, blob) == 2
        got = np.asarray(dst.pool_k)[:, dst.match_prefix(ids)[1]]
    assert set(blob) == {"ids", "k", "v", "block_size"}
    assert blob["k"].shape == (2, 2, 2, 4, 4) and blob["ids"] == ids[:8]
    np.testing.assert_array_equal(got, np.moveaxis(
        ck[:, 1, :, :8].reshape(2, 2, 2, 4, 4), 2, 1))


def test_prefix_blob_bf16_from_jax():
    jkv = JK.PagedKVCache(2, 2, 4, num_blocks=4, block_size=4,
                          dtype=jnp.bfloat16)
    pkv = PK.PagedKVCache(2, 2, 4, num_blocks=4, block_size=4,
                          dtype=torch.bfloat16, device="cpu")
    ck, cv = _fake_cache()
    jkv.store_prefix(list(range(8)), {"k": jnp.asarray(ck, jnp.bfloat16),
                                      "v": jnp.asarray(cv, jnp.bfloat16)}, 0)
    blob = JK.export_prefix(jkv, list(range(8)))
    assert PK.import_prefix(pkv, blob) == 2
    np.testing.assert_array_equal(
        pkv.pool_k.float().numpy(), np.asarray(jkv.pool_k, np.float32))
    back = PK.export_prefix(pkv, list(range(8)))
    np.testing.assert_array_equal(back["k"], np.asarray(blob["k"],
                                                        np.float32))


# ------------------------------------------------------------------ engines
PROMPTS = [
    "the quick brown fox jumps over the lazy dog " * 2,   # > chunk of 16
    "hello",
    "the quick brown fox jumps over the lazy dog " * 2 + "and then",
    "a shorter prompt with its own tail",
    "the quick brown fox jumps over the lazy dog " * 2,   # exact repeat
]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A gpt2-tiny checkpoint in the shared format with seeded weights
    larger than GPT-2's init: with N(0, 0.02) weights and tied embeddings a
    greedy stream only repeats its last input token, which would make the
    stream comparison weak."""
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


def _engines(checkpoint, **kw):
    common = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=128,
                  kv_blocks=32, kv_block_size=8, checkpoint=checkpoint, **kw)
    jeng = JS.LLMEngine(model_overrides={"dtype": jnp.float32},
                        weight_store=False, **common)
    peng = PS.LLMEngine(model_overrides={"dtype": torch.float32},
                        device="cpu", **common)
    return jeng, peng


@pytest.mark.parametrize("scheduler", ["continuous", "fixed"])
@pytest.mark.parametrize("prefix", [True, False])
def test_engine_greedy_streams_match_jax(checkpoint, scheduler, prefix):
    jeng, peng = _engines(checkpoint, scheduler=scheduler,
                          enable_prefix_caching=prefix)
    try:
        for prompt in PROMPTS:
            want = jeng.generate(prompt, max_tokens=10)
            got = peng.generate(prompt, max_tokens=10)
            assert got == want
            assert len(set(got["token_ids"])) > 1   # not a repeated token
        if prefix:
            assert peng.kv.stats() == jeng.kv.stats()
            assert peng.kv.stats()["prefix_hits"] >= 2
        for key in ("total_generated", "engine_steps", "chunk_steps",
                    "tokens_prefilled"):
            assert peng.engine_stats()[key] == jeng.engine_stats()[key]
    finally:
        jeng.shutdown()
        peng.shutdown()


@pytest.fixture
def tiny_server():
    server = PS.LLMServer(preset="gpt2-tiny", max_batch=2, max_seq_len=64,
                          model_overrides={"dtype": torch.float32},
                          device="cpu")
    yield server
    server.shutdown()


def test_server_call_response_shape(tiny_server):
    out = tiny_server({"prompt": "hi there", "max_tokens": 5})
    assert out["object"] == "text_completion"
    (choice,) = out["choices"]
    assert set(choice) == {"text", "index", "token_ids", "finish_reason"}
    assert len(choice["token_ids"]) == out["usage"]["completion_tokens"] <= 5
    assert choice["text"] == PS.ByteTokenizer().decode(choice["token_ids"])
    by_ids = tiny_server({"prompt_ids": PS.ByteTokenizer().encode("hi there"),
                          "max_tokens": 5})
    assert by_ids["choices"][0]["token_ids"] == choice["token_ids"]
    stats = tiny_server.stats()
    assert stats["total_generated"] >= 1 and "kv_cache" in stats
    tiny_server.check_health()


def test_stream_matches_generate(tiny_server):
    eng = tiny_server.engine
    want = eng.generate("streaming", max_tokens=6)
    sid = eng.start_stream("streaming", max_tokens=6)
    cursor, toks, text = 0, [], ""
    deadline = time.time() + 60
    while time.time() < deadline:
        part = eng.stream_next(sid, cursor)
        toks += part["token_ids"]
        text += part["text"]
        cursor = part["cursor"]
        if part["done"]:
            break
    assert toks == want["token_ids"] and text == want["text"]
    with pytest.raises(KeyError):
        eng.stream_next(sid)


def test_step_failure_surfaces_and_engine_survives(tiny_server):
    eng = tiny_server.engine
    real = eng.gpt2

    class Broken:
        def __getattr__(self, name):
            if name in ("decode_step", "prefill_chunk"):
                def boom(*a, **k):
                    raise RuntimeError("injected step failure")
                return boom
            return getattr(real, name)

    eng.gpt2 = Broken()
    try:
        with pytest.raises(RuntimeError, match="injected step failure"):
            eng.generate("this step fails", max_tokens=4, timeout=30)
    finally:
        eng.gpt2 = real
    assert eng.engine_stats()["step_errors"] == 1
    tiny_server.check_health()
    assert eng.generate("and this one works", max_tokens=3)["token_ids"]


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.LLMEngine(preset="gpt2-tiny")


def test_engine_rejects_tensor_parallel():
    # tp runs (test_torch_serve_tp.py) where it divides n_head and d_ff
    with pytest.raises(ValueError, match="divide n_head"):
        PS.LLMEngine(preset="gpt2-tiny", tensor_parallel_size=3,
                     device="cpu")
