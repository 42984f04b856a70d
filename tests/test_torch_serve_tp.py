"""The tensor-parallel serving engine (`LLMEngine(tensor_parallel_size=2)`,
`gpt2.tp_shards` / `tp_prefill_chunk`, the per-device prefix pools of
`serve/kv_cache.py`) against the JAX package's tp engine.

The JAX engine is single-controller SPMD on two of this process's virtual
CPU devices (params placed by `gpt2.param_specs` on a tp mesh, the KV
cache sharded over heads); the port's drives two shards on the CPU from
one process, their partial sums meeting in a `LocalCollectiveGroup`. Both
serve the same gpt2-tiny checkpoint in float32
(`test_torch_serve_llm.checkpoint`):

- greedy streams equal to JAX's tp=2 engine and to the port's tp=1
  engine, for both schedulers, with and without prefix caching;
- the first step's logits within 1e-4 of JAX's tp=2 step;
- prefix caching on a tp engine: a second call hits and its stream stays;
  a tp engine's KV blobs equal a one-device engine's and move both ways;
- `OpenAIServer` on a tp engine: an adapter's stream equals the one-device
  server's (JAX's tp engine serves LoRA tenants too);
- the refusals: tp not dividing n_head, a device list of another length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.serve import llm as JS
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve import llm as PS
from test_torch_serve_llm import PROMPTS, checkpoint  # noqa: F401
from test_torch_serve_openai import ADAPTERS, _write_adapters

COMMON = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=128,
              kv_blocks=32, kv_block_size=8)


def _port(checkpoint, tp, **kw):
    return PS.LLMEngine(model_overrides={"dtype": torch.float32},
                        device="cpu", checkpoint=checkpoint,
                        tensor_parallel_size=tp, **COMMON, **kw)


def _jax(checkpoint, tp, **kw):
    return JS.LLMEngine(model_overrides={"dtype": jnp.float32},
                        weight_store=False, checkpoint=checkpoint,
                        tensor_parallel_size=tp, **COMMON, **kw)


@pytest.mark.parametrize("scheduler", ["continuous", "fixed"])
@pytest.mark.parametrize("prefix", [True, False])
def test_tp_streams_match_jax_and_one_device(checkpoint, scheduler, prefix):
    kw = dict(scheduler=scheduler, enable_prefix_caching=prefix)
    engines = [_jax(checkpoint, 2, **kw), _port(checkpoint, 2, **kw),
               _port(checkpoint, 1, **kw)]
    try:
        assert len({d.id for a in jax.tree.leaves(engines[0].params)
                    for d in a.sharding.device_set}) == 2
        for prompt in PROMPTS:
            want, got, one = (e.generate(prompt, max_tokens=10)
                              for e in engines)
            assert got == want == one
        if prefix:
            assert engines[1].kv.stats() == engines[0].kv.stats()
            assert engines[1].kv.stats()["prefix_hits"] >= 1
        for key in ("total_generated", "engine_steps", "chunk_steps",
                    "tokens_prefilled"):
            assert engines[1].engine_stats()[key] == \
                engines[0].engine_stats()[key]
    finally:
        for e in engines:
            e.shutdown()


def test_tp_first_step_logits_match_jax(checkpoint):
    jeng = _jax(checkpoint, 2, enable_prefix_caching=False)
    peng = _port(checkpoint, 2, enable_prefix_caching=False)
    one = _port(checkpoint, 1, enable_prefix_caching=False)
    try:
        rng = np.random.default_rng(3)
        tokens = rng.integers(1, 257, (2, 16))
        pos0, length = np.array([0, 0]), np.array([16, 9])
        active = np.array([True, True])
        want, _ = jeng._chunk_step(
            jeng.params, jeng.cache, *(jnp.asarray(a) for a in
                                       (tokens, pos0, length, active)))
        args = [torch.from_numpy(a) for a in (tokens, pos0, length, active)]
        with torch.inference_mode():
            got, caches = PG.tp_prefill_chunk(
                peng.shards, PG.tp_init_caches(peng.cfg, 2, 128,
                                               peng.devices),
                *args, peng.cfg, peng.group.allreduce)
            ref, cache = PG.prefill_chunk(
                one.params, PG.init_cache(one.cfg, 2, 128, device="cpu"),
                *args, one.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=0)
        # each device's cache holds its heads of the one-device cache
        for s, c in enumerate(caches):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    c[kv].numpy(), cache[kv][:, :, 2 * s:2 * s + 2].numpy(),
                    atol=1e-5, rtol=0)
    finally:
        for e in (jeng, peng, one):
            e.shutdown()


def test_tp_prefix_cache_hits_and_blobs_move_both_ways(checkpoint):
    tp, one = _port(checkpoint, 2), _port(checkpoint, 1)
    jone = _jax(checkpoint, 1)
    try:
        prompt = "a long shared prefix for the tp engine " * 2
        want = one.generate(prompt, max_tokens=6)["token_ids"]
        assert tp.generate(prompt, max_tokens=6)["token_ids"] == want
        assert tp.generate(prompt, max_tokens=6)["token_ids"] == want
        assert tp.kv.stats()["prefix_hits"] >= 1
        blob, ref = tp.export_prefix(prompt), one.export_prefix(prompt)
        assert blob["ids"] == ref["ids"] and len(blob["ids"]) >= 64
        for kv in ("k", "v"):
            assert blob[kv].shape == ref[kv].shape
            np.testing.assert_allclose(blob[kv], ref[kv], atol=1e-5, rtol=0)
        fresh = _port(checkpoint, 2)
        try:
            assert fresh.import_prefix(ref) == len(ref["ids"]) // 8
            assert fresh.generate(prompt, max_tokens=6)["token_ids"] == want
            assert fresh.kv.stats()["prefix_hits"] >= 1
        finally:
            fresh.shutdown()
        assert jone.import_prefix(blob) == len(blob["ids"]) // 8
        assert jone.generate(prompt, max_tokens=6)["token_ids"] == want
    finally:
        for e in (tp, one, jone):
            e.shutdown()


def test_tp_openai_server_serves_adapters(checkpoint, tmp_path):
    root = _write_adapters(tmp_path, PG.GPT2Config.preset("gpt2-tiny"))
    kw = dict(model_id="tiny", lora_root=root, max_loras=2,
              model_overrides={"dtype": torch.float32}, device="cpu",
              checkpoint=checkpoint, **COMMON)
    servers = [PS.OpenAIServer(tensor_parallel_size=tp, **kw)
               for tp in (2, 1)]
    try:
        for model in ("tiny", f"tiny:{ADAPTERS[0]}"):
            outs = [srv({"prompt": PROMPTS[3], "max_tokens": 6,
                         "model": model}) for srv in servers]
            assert outs[0]["choices"][0]["text"] == \
                outs[1]["choices"][0]["text"]
        assert servers[0]._lora_engines[ADAPTERS[0]].tp == 2
    finally:
        for srv in servers:
            srv.engine.shutdown()
            for eng in srv._lora_engines.values():
                eng.shutdown()


def test_tp_refusals():
    with pytest.raises(ValueError, match="divide n_head"):
        PS.LLMEngine(preset="gpt2-tiny", tensor_parallel_size=3,
                     device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        PS.LLMEngine(preset="gpt2-tiny", tensor_parallel_size=2,
                     device=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PS.LLMEngine(preset="gpt2-tiny", tensor_parallel_size=2)
