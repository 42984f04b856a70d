"""ray_tpu_torch's KV transfer between engines and deferred prefix admission
against the JAX package: `export_prefix` / `import_prefix` between two port
engines and across the packages, requests parked behind a prefix future
(tests/test_prefix_store.py's async-fetch case, on the port), and the
prefix-store keys (`weights_id`, `prefix_model_key`).

Engines serve gpt2-tiny in float32 with seeded weights (JAX: model_overrides
{"dtype": float32}, weight_store=False). Every wait is bounded.
"""

import threading
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.serve import llm as JS
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve import llm as PS

TIMEOUT = 60
PROMPT = "disaggregated prefill ships kv blocks across replicas " * 2


def _ids(n, salt=0):
    return [(i * 7 + salt * 131) % 500 + 1 for i in range(n)]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """gpt2-tiny with seeded weights larger than GPT-2's init, so greedy
    streams vary."""
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


KW = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=160, kv_blocks=32,
          kv_block_size=8)


def _port(checkpoint, **kw):
    return PS.LLMEngine(model_overrides={"dtype": torch.float32},
                        device="cpu", checkpoint=checkpoint, **{**KW, **kw})


def _jax(checkpoint, **kw):
    return JS.LLMEngine(model_overrides={"dtype": jnp.float32},
                        weight_store=False, checkpoint=checkpoint,
                        **{**KW, **kw})


@pytest.fixture(scope="module")
def cold(checkpoint):
    """A port engine without prefix caching: the reference output."""
    eng = _port(checkpoint, enable_prefix_caching=False)
    yield eng
    eng.shutdown()


def test_kv_transfer_between_port_engines(checkpoint, cold):
    """A prefill engine exports a prompt's KV, a decode engine imports it and
    skips prefill for the covered span: the same greedy output as a cold
    engine (the port of tests/test_serve_llm_kv.py's transfer case)."""
    prefill, decode = _port(checkpoint), _port(checkpoint)
    try:
        want = cold.generate(PROMPT, max_tokens=8, timeout=TIMEOUT)
        blob = prefill.export_prefix(PROMPT)
        assert blob is not None and len(blob["ids"]) > 0
        n_ids = len(PS.ByteTokenizer().encode(PROMPT)) - 1
        assert len(blob["ids"]) == n_ids - n_ids % 8
        assert decode.import_prefix(blob) == len(blob["ids"]) // 8
        got = decode.generate(PROMPT, max_tokens=8, timeout=TIMEOUT)
        assert got == want
        st = decode.kv.stats()
        assert st["prefix_hits"] >= 1 and st["tokens_reused"] > 0
        assert decode.engine_stats()["tokens_prefilled"] == \
            n_ids + 1 - len(blob["ids"])
        assert decode.import_prefix(blob) == 0          # dedup'd
        with pytest.raises(ValueError, match="block_size"):
            decode.import_prefix(dict(blob, block_size=4))
    finally:
        prefill.shutdown()
        decode.shutdown()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kv_transfer_across_packages(checkpoint, cold, direction):
    jeng, peng = _jax(checkpoint), _port(checkpoint)
    src, dst = (jeng, peng) if direction == "jax_to_port" else (peng, jeng)
    try:
        want = cold.generate(PROMPT, max_tokens=8, timeout=TIMEOUT)
        blob = src.export_prefix(PROMPT)
        assert set(blob) == {"ids", "k", "v", "block_size"}
        assert dst.import_prefix(blob) == len(blob["ids"]) // 8
        assert dst.generate(PROMPT, max_tokens=8, timeout=TIMEOUT) == want
        assert dst.kv.stats()["tokens_reused"] == len(blob["ids"])
    finally:
        jeng.shutdown()
        peng.shutdown()


def test_deferred_prefix_admission(checkpoint):
    """A request whose blob is still in flight does not block admission:
    another lane completes meanwhile; when the blob lands it is imported on
    the engine thread and the request prefills only past it, with the cold
    output. A future that never resolves times out into a local prefill."""
    kw = dict(kv_blocks=64)
    donor, eng, jeng = (_port(checkpoint, **kw), _port(checkpoint, **kw),
                        _jax(checkpoint, enable_prefix_caching=False))
    try:
        ids = _ids(41)                      # 5 full blocks in ids[:-1]
        want = jeng.generate(prompt_ids=ids, max_tokens=6,
                             timeout=TIMEOUT)["token_ids"]
        assert donor.generate(prompt_ids=ids, max_tokens=6,
                              timeout=TIMEOUT)["token_ids"] == want
        blob = donor.export_prefix(prompt_ids=ids)
        assert blob is not None and len(blob["ids"]) == 40

        fut = Future()                      # unresolved: blob "in flight"
        result = {}

        def deferred():
            result["out"] = eng.generate(prompt_ids=ids, max_tokens=6,
                                         prefix_future=fut,
                                         prefix_wait_s=TIMEOUT,
                                         timeout=TIMEOUT)

        t = threading.Thread(target=deferred, daemon=True)
        t.start()
        other = eng.generate(prompt_ids=_ids(5, salt=3), max_tokens=5,
                             timeout=TIMEOUT)
        assert len(other["token_ids"]) == 5, "a lane starved behind the wait"
        assert not result, "the deferred request ran before its blob landed"
        assert eng.engine_stats()["deferred"] == 1
        prefilled = eng.engine_stats()["tokens_prefilled"]
        fut.set_result(blob)
        t.join(TIMEOUT)
        assert not t.is_alive()
        assert result["out"]["token_ids"] == want
        st = eng.engine_stats()
        assert st["prefix_imports"] == 1 and st["deferred"] == 0
        assert st["prefix_blocks_imported"] == 5
        # the deferred request prefilled only past the imported span
        assert st["tokens_prefilled"] - prefilled == 41 - 40

        never = Future()
        ids2 = _ids(30, salt=5)
        out = eng.generate(prompt_ids=ids2, max_tokens=4,
                           prefix_future=never, prefix_wait_s=0.3,
                           timeout=TIMEOUT)
        assert out["token_ids"] == jeng.generate(
            prompt_ids=ids2, max_tokens=4, timeout=TIMEOUT)["token_ids"]
        assert eng.engine_stats()["prefix_wait_timeouts"] == 1
        assert never.cancelled()
    finally:
        donor.shutdown()
        eng.shutdown()
        jeng.shutdown()


def test_export_pooled_from_engine_thread(checkpoint):
    """export_pooled called on the engine thread itself runs there and then
    (no wait on its own queue), and a call queued from outside runs between
    steps."""
    eng = _port(checkpoint)
    try:
        ids = _ids(25)
        eng.generate(prompt_ids=ids, max_tokens=2, timeout=TIMEOUT)
        outside = eng.export_pooled(ids[:-1])
        inside = eng._on_engine(lambda: (threading.current_thread(),
                                         eng.export_pooled(ids[:-1])),
                                timeout=TIMEOUT)
        assert inside[0] is eng._thread
        assert inside[1]["ids"] == outside["ids"] == ids[:24]
        np.testing.assert_array_equal(inside[1]["k"], outside["k"])
    finally:
        eng.shutdown()


def test_shutdown_fails_waiting_requests(checkpoint):
    """Requests an engine still holds when it stops (here one parked behind
    a prefix future that never resolves) fail at once instead of waiting
    out their timeout; a request after the stop is refused."""
    eng = _port(checkpoint)
    result = {}

    def parked():
        try:
            eng.generate(prompt_ids=_ids(20), max_tokens=3,
                         prefix_future=Future(), prefix_wait_s=TIMEOUT,
                         timeout=TIMEOUT)
        except RuntimeError as e:
            result["error"] = str(e)

    t = threading.Thread(target=parked, daemon=True)
    t.start()
    for _ in range(200):
        if eng.engine_stats()["deferred"] == 1:
            break
        t.join(0.01)
    assert eng.engine_stats()["deferred"] == 1
    eng.shutdown()
    t.join(TIMEOUT)
    assert not eng._thread.is_alive() and not t.is_alive()
    assert result["error"] == "engine shut down"
    with pytest.raises(RuntimeError, match="shut down"):
        eng.generate("late", max_tokens=2, timeout=TIMEOUT)


@pytest.mark.parametrize("source", ["preset", "checkpoint", "override"])
def test_prefix_model_key_matches_jax(checkpoint, source):
    kw = dict(preset="gpt2-tiny", max_batch=1, max_seq_len=64, seed=3,
              kv_blocks=4, kv_block_size=16)
    if source == "checkpoint":
        kw["checkpoint"] = checkpoint
    jeng = JS.LLMEngine(weight_store=False, **kw)
    if source == "override":
        pbase = PS.LLMEngine(device="cpu", **kw)
        peng = PS.LLMEngine(device="cpu", params_override=pbase.params,
                            cfg_override=pbase.cfg, **kw)
        jover = JS.LLMEngine(weight_store=False, params_override=jeng.params,
                             cfg_override=jeng.cfg, **kw)
        named = [PS.LLMEngine(device="cpu", params_override=pbase.params,
                              weights_id=jeng.weights_id, **kw)]
        engines = [pbase, peng, jover] + named
    else:
        peng = PS.LLMEngine(device="cpu", **kw)
        engines = [peng]
    try:
        if source == "override":
            # an override without an id gets a unique one in both packages
            assert peng.weights_id.startswith("override-")
            assert jover.weights_id.startswith("override-")
            assert peng.weights_id != pbase.weights_id
            assert len(peng.weights_id) == len(jover.weights_id)
            assert named[0].prefix_model_key == jeng.prefix_model_key
            assert named[0].weights_id == jeng.weights_id
        else:
            assert peng.weights_id == jeng.weights_id
            assert peng.prefix_model_key == jeng.prefix_model_key
        key = jeng.prefix_model_key
        assert key.endswith("|L2H4D32|bfloat16|bs16"), key
        f32 = [JS.LLMEngine(weight_store=False,
                            model_overrides={"dtype": jnp.float32}, **kw),
               PS.LLMEngine(device="cpu",
                            model_overrides={"dtype": torch.float32}, **kw)]
        engines += f32
        assert f32[0].prefix_model_key == f32[1].prefix_model_key
        assert "|float32|" in f32[1].prefix_model_key
        off = PS.LLMEngine(device="cpu", enable_prefix_caching=False, **kw)
        engines.append(off)
        assert off.prefix_model_key is None
    finally:
        jeng.shutdown()
        for eng in engines:
            eng.shutdown()
