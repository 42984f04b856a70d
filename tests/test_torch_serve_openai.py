"""ray_tpu_torch's OpenAI-compatible serving surface against the JAX package:
LoRA merges (`gpt2.apply_lora`, `load_lora_npz`), `OpenAIServer` with LoRA
tenants under an LRU, server streaming, `batch_call` and `HFTokenizer`.

Both packages serve one seeded checkpoint in float32 (JAX: model_overrides
{"dtype": float32} and weight_store=False, as tests/test_torch_serve_llm.py
runs it); adapters are npz files written by numpy and loaded by both. Greedy
answers must be equal. Every wait is bounded.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.serve import compiled_chain as JC
from ray_tpu.serve import llm as JS
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve import compiled_chain as PC
from ray_tpu_torch.serve import llm as PS

TIMEOUT = 60
ADAPTERS = ("alpha_big", "beta", "gamma")


def _seeded_flat(cfg, seed=7):
    """Path-keyed numpy weights larger than GPT-2's init, so greedy streams
    vary (with N(0, 0.02) and tied embeddings a stream repeats its last
    prompt token)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in PG.param_shapes(cfg).items():
        matrix = len(shape) - key.startswith("blocks/") == 2
        if key.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        else:
            a = (0.2 if matrix else 0.05) * rng.standard_normal(shape)
        flat[key] = a.astype(np.float32)
    return flat


def _save_checkpoint(path, cfg, seed=7):
    params = PG.params_from_numpy(_seeded_flat(cfg, seed), cfg, device="cpu")
    return PG.save_params(str(path), params, cfg)


def _write_adapters(root, cfg, seed=0):
    """Three adapters: rank 4 on the stacked wqkv (alpha given), rank 2 on
    the stacked mlp.wi (one with alpha defaulted to r)."""
    rng = np.random.default_rng(seed)
    L, D, F = cfg.n_layer, cfg.d_model, cfg.d_ff
    for name, scale in zip(ADAPTERS, (4.0, 0.5, 1.0)):
        arrays = {
            "blocks.attn.wqkv.A": rng.normal(size=(L, D, 4)) * 0.3 * scale,
            "blocks.attn.wqkv.B": rng.normal(size=(L, 4, 3 * D)) * 0.3 * scale,
            "blocks.attn.wqkv.alpha": np.float32(8.0),
            "blocks.mlp.wi.A": rng.normal(size=(L, D, 2)) * 0.2 * scale,
            "blocks.mlp.wi.B": rng.normal(size=(L, 2, F)) * 0.2 * scale,
        }
        if name == "beta":
            arrays["blocks.mlp.wi.alpha"] = np.float32(1.0)
        np.savez(os.path.join(root, f"{name}.npz"),
                 **{k: np.asarray(v, np.float32) for k, v in arrays.items()})
    return str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = PG.GPT2Config.preset("gpt2-tiny")
    return _save_checkpoint(tmp_path_factory.mktemp("ckpt"), cfg)


@pytest.fixture(scope="module")
def lora_root(tmp_path_factory):
    return _write_adapters(tmp_path_factory.mktemp("lora"),
                           PG.GPT2Config.preset("gpt2-tiny"))


def _server_pair(checkpoint, lora_root=None, **kw):
    common = dict(model_id="tiny", lora_root=lora_root, max_loras=2,
                  preset="gpt2-tiny", max_batch=2, max_seq_len=96,
                  checkpoint=checkpoint, kv_blocks=32, kv_block_size=8, **kw)
    jsrv = JS.OpenAIServer(model_overrides={"dtype": jnp.float32},
                           weight_store=False, **common)
    psrv = PS.OpenAIServer(model_overrides={"dtype": torch.float32},
                           device="cpu", **common)
    return jsrv, psrv


def _shutdown_jax(srv):
    srv.engine.shutdown()
    for eng in srv._lora_engines.values():
        eng.shutdown()


@pytest.fixture(scope="module")
def base_pair(checkpoint):
    """Both packages' servers of the checkpoint, without adapters."""
    jsrv, psrv = _server_pair(checkpoint)
    yield jsrv, psrv
    _shutdown_jax(jsrv)
    psrv.shutdown()


class _Path:
    def __init__(self, path, body=None):
        self.path, self.json = path, body


def _answer(out):
    """A response without its id (a clock reading)."""
    return {k: v for k, v in out.items() if k != "id"}


# ----------------------------------------------------------------- LoRA merge
def _params_pair(cfg):
    flat = _seeded_flat(cfg, seed=3)
    jparams = {}
    for key, a in flat.items():
        node = jparams
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(a)
    return jparams, PG.params_from_numpy(flat, cfg, device="cpu")


@pytest.mark.parametrize("alpha", [8.0, None], ids=["alpha", "default"])
@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked", "unstacked"])
def test_apply_lora_matches_jax(stacked, alpha):
    cfg = PG.GPT2Config.preset("gpt2-tiny")
    L, D, V, S = cfg.n_layer, cfg.d_model, cfg.vocab_size, cfg.max_seq_len
    rng = np.random.default_rng(11)
    if stacked:
        shapes = {"blocks.attn.wqkv": ((L, D, 4), (L, 4, 3 * D)),
                  "blocks.mlp.wo": ((L, cfg.d_ff, 4), (L, 4, D))}
    else:
        shapes = {"wte": ((V, 4), (4, D)), "wpe": ((S, 2), (2, D))}
    adapter = {}
    for path, (a, b) in shapes.items():
        adapter[path] = {"A": rng.normal(size=a).astype(np.float32),
                         "B": rng.normal(size=b).astype(np.float32)}
        if alpha is not None:
            adapter[path]["alpha"] = np.float32(alpha)
    jparams, pparams = _params_pair(cfg)
    before = PG.params_to_numpy(pparams)
    leaves = dict(PG._flatten(pparams))
    jmerged = JG.apply_lora(jparams, adapter)
    pmerged = PG.apply_lora(pparams, adapter)

    targeted = {p.replace(".", "/") for p in shapes}
    jflat = {k: np.asarray(v) for k, v in PG._flatten(jmerged).items()}
    for key, leaf in PG._flatten(pmerged).items():
        np.testing.assert_array_equal(leaf.numpy(), jflat[key])
        if key in targeted:
            assert leaf is not leaves[key]
            assert not np.array_equal(leaf.numpy(), before[key])
        else:
            assert leaf is leaves[key]       # shared with the base
    for key, a in PG.params_to_numpy(pparams).items():
        np.testing.assert_array_equal(a, before[key])   # base unchanged
    if stacked:
        assert pmerged["blocks"] is not pparams["blocks"]
        assert pmerged["blocks"]["ln1"] is pparams["blocks"]["ln1"]


@pytest.mark.parametrize("fault", ["shape", "missing"])
def test_lora_errors_match_jax(tmp_path, fault):
    cfg = PG.GPT2Config.preset("gpt2-tiny")
    jparams, pparams = _params_pair(cfg)
    if fault == "shape":
        bad = {"blocks.attn.wqkv": {"A": np.ones((2, 128, 4), np.float32),
                                    "B": np.ones((2, 4, 200), np.float32)}}
        with pytest.raises(ValueError) as jerr:
            JG.apply_lora(jparams, bad)
        with pytest.raises(ValueError) as perr:
            PG.apply_lora(pparams, bad)
    else:
        path = str(tmp_path / "broken.npz")
        np.savez(path, **{"blocks.mlp.wi.A": np.ones((2, 128, 2), np.float32),
                          "wte.A": np.ones((512, 2), np.float32),
                          "wte.B": np.ones((2, 128), np.float32)})
        with pytest.raises(ValueError) as jerr:
            JG.load_lora_npz(path)
        with pytest.raises(ValueError) as perr:
            PG.load_lora_npz(path)
    assert str(perr.value) == str(jerr.value)
    assert "at 'blocks.attn.wqkv'" in str(perr.value) or \
        "blocks.mlp.wi" in str(perr.value)


def test_load_lora_npz_matches_jax(lora_root):
    for name in ADAPTERS:
        path = os.path.join(lora_root, f"{name}.npz")
        want, got = JG.load_lora_npz(path), PG.load_lora_npz(path)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].keys() == want[k].keys()
            for part in want[k]:
                np.testing.assert_array_equal(got[k][part], want[k][part])


# -------------------------------------------------------------- OpenAIServer
def test_openai_lora_tenants_match_jax(checkpoint, lora_root):
    """Base and three adapters, completions and chat: equal greedy text and
    usage; /v1/models lists the same entries; the LRU evicts the same
    adapter, and the evicted engine's thread is gone."""
    jsrv, psrv = _server_pair(checkpoint, lora_root)
    try:
        completion = {"prompt": "the quick brown fox", "max_tokens": 8,
                      "temperature": 0.0}
        chat = {"messages": [{"role": "system", "content": "be brief"},
                             {"role": "user", "content": "hello there"}],
                "max_tokens": 6, "temperature": 0.0}
        base_text = None
        evicted = None
        for model in ["tiny"] + [f"tiny:{a}" for a in ADAPTERS]:
            if model == "tiny:gamma":
                evicted = psrv._lora_engines["alpha_big"]
            for path, body in (("/v1/completions", completion),
                               ("/v1/chat/completions", chat)):
                req = _Path(path, {**body, "model": model})
                want, got = jsrv(req), psrv(req)
                assert _answer(got) == _answer(want), (model, path)
                assert got["usage"]["completion_tokens"] == \
                    body["max_tokens"]
            if model == "tiny":
                base_text = got["choices"][0]["message"]["content"]
            else:
                assert got["choices"][0]["message"]["content"] != base_text
            assert psrv.loaded_lora_ids() == jsrv.loaded_lora_ids()
        assert psrv.loaded_lora_ids() == ["beta", "gamma"]
        evicted._thread.join(TIMEOUT)
        assert not evicted._thread.is_alive()
        # the merged engines carry their own weights; the base is untouched
        eng = psrv._lora_engines["gamma"]
        assert not torch.equal(eng.params["blocks"]["attn"]["wqkv"],
                               psrv.engine.params["blocks"]["attn"]["wqkv"])
        assert eng.params["wte"] is psrv.engine.params["wte"]
        assert eng.weights_id == psrv.engine.weights_id
        again = psrv(_Path("/v1/chat/completions", {**chat, "model": "tiny"}))
        assert again["choices"][0]["message"]["content"] == base_text
        assert psrv(_Path("/v1/models")) == jsrv(_Path("/v1/models"))
    finally:
        _shutdown_jax(jsrv)
        psrv.shutdown()


def test_openai_lora_checkpoint_architecture_matches_jax(tmp_path):
    """A checkpoint whose architecture differs from its preset (3 layers,
    d_model 64 against gpt2-tiny's 2 and 128): adapter engines take the
    base's resolved config and serve without a shape error."""
    cfg = PG.GPT2Config.preset("gpt2-tiny", n_layer=3, n_head=4, d_model=64,
                               d_ff=256, max_seq_len=96)
    ckpt = _save_checkpoint(tmp_path / "ckpt", cfg, seed=5)
    rng = np.random.default_rng(0)
    L, D = cfg.n_layer, cfg.d_model
    np.savez(str(tmp_path / "ad.npz"), **{
        "blocks.attn.wqkv.A": rng.normal(size=(L, D, 4)).astype(np.float32),
        "blocks.attn.wqkv.B": rng.normal(size=(L, 4, 3 * D)).astype(
            np.float32)})
    jsrv, psrv = _server_pair(ckpt, str(tmp_path),
                              enable_prefix_caching=False)
    try:
        assert psrv.engine.cfg.n_layer == 3 and psrv.engine.cfg.d_model == 64
        body = {"prompt": "hello world", "max_tokens": 4,
                "temperature": 0.0, "model": "tiny:ad"}
        want, got = jsrv(body), psrv(body)
        assert _answer(got) == _answer(want)
        assert got["usage"]["completion_tokens"] == 4
        eng = psrv._lora_engines["ad"]
        assert eng.cfg == psrv.engine.cfg
        assert eng.params["blocks"]["attn"]["wqkv"].shape == \
            psrv.engine.params["blocks"]["attn"]["wqkv"].shape
    finally:
        _shutdown_jax(jsrv)
        psrv.shutdown()


def _drain(server, sid):
    toks, text, cursor = [], "", 0
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        part = server.stream_next(sid, cursor)
        toks += part["token_ids"]
        text += part["text"]
        cursor = part["cursor"]
        if part["done"]:
            return toks, text, part
    raise TimeoutError("stream did not finish")


@pytest.mark.parametrize("mode", ["completion", "chat"])
def test_openai_stream_matches_nonstream(base_pair, mode):
    jsrv, psrv = base_pair
    if mode == "chat":
        path = "/v1/chat/completions"
        body = {"messages": [{"role": "user", "content": "stream me a line"}],
                "max_tokens": 7, "temperature": 0.0}
    else:
        path = "/v1/completions"
        body = {"prompt": "stream me a line", "max_tokens": 7,
                "temperature": 0.0}
    want = psrv(_Path(path, body))
    text = (want["choices"][0]["message"]["content"] if mode == "chat"
            else want["choices"][0]["text"])
    jmark = jsrv(_Path(path, {**body, "stream": True}))
    pmark = psrv(_Path(path, {**body, "stream": True}))
    assert set(pmark) == set(jmark) == {"__sse_stream__"}
    pinfo, jinfo = pmark["__sse_stream__"], jmark["__sse_stream__"]
    assert set(pinfo) == set(jinfo)
    assert {k: v for k, v in pinfo.items() if k != "stream_id"} == \
        {k: v for k, v in jinfo.items() if k != "stream_id"}
    assert pinfo["mode"] == mode
    toks, got_text, last = _drain(psrv, pinfo["stream_id"])
    jtoks, jtext, _ = _drain(jsrv, jinfo["stream_id"])
    assert toks == jtoks and got_text == jtext == text
    assert len(toks) == want["usage"]["completion_tokens"] == 7
    assert last["finish_reason"] == "length"
    assert pinfo["stream_id"] not in psrv._stream_owner
    with pytest.raises(KeyError):
        psrv.stream_next(pinfo["stream_id"])


def test_batch_call_order_and_isolation(base_pair):
    jsrv, psrv = base_pair
    assert PC.CHAIN_ERR == JC.CHAIN_ERR
    reqs = [{"prompt": f"request number {i} " * (i + 1), "max_tokens": 3 + i,
             "temperature": 0.0} for i in range(5)]
    reqs.insert(2, {"prompt": "malformed", "max_tokens": "x"})
    reqs.append({"prompt_ids": [5, 6, 7, 8, 9], "max_tokens": 4,
                 "temperature": 0.0})
    steps0 = psrv.engine.engine_stats()["engine_steps"]
    got = psrv.batch_call(reqs)
    steps = psrv.engine.engine_stats()["engine_steps"] - steps0
    want = jsrv.batch_call(reqs)
    assert len(got) == len(reqs)
    bad = got[2]
    assert set(bad) == {PC.CHAIN_ERR, "infra"} and bad["infra"] is False
    assert "ValueError" in bad[PC.CHAIN_ERR]
    assert bad == want[2]
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            continue
        assert _answer(g) == _answer(w)
        assert g["usage"]["completion_tokens"] == reqs[i]["max_tokens"]
        # in order: each answer is its own request's
        assert _answer(g) == _answer(psrv(reqs[i]))
    generated = sum(g["usage"]["completion_tokens"]
                    for i, g in enumerate(got) if i != 2)
    assert steps < generated    # the items shared steps


def test_cluster_prefix_cache_keys_the_store_by_the_base_model(checkpoint,
                                                               lora_root):
    """`cluster_prefix_cache=True` gives LLMServer and OpenAIServer a
    prefix store keyed by the base model (the engine's prefix_model_key,
    the JAX package's string for the same engine); an adapter engine keeps
    the base's key. Outside a runtime the store publishes nothing."""
    kw = dict(checkpoint=checkpoint, max_seq_len=96, max_batch=2,
              kv_blocks=16, kv_block_size=8, cluster_prefix_cache=True)
    llm = PS.LLMServer(device="cpu", **kw)
    oai = PS.OpenAIServer(model_id="tiny", lora_root=lora_root,
                          device="cpu", **kw)
    jsrv = JS.LLMServer(**kw)
    try:
        for srv in (llm, oai):
            assert srv.prefix_store is not None
            assert srv.prefix_store.model_key == \
                srv.engine.prefix_model_key == \
                jsrv.prefix_store.model_key
            assert srv.prefix_store.block_size == 8
        body = {"prompt_ids": list(range(1, 30)), "max_tokens": 2}
        llm(body)
        assert llm.stats()["prefix_store"]["published"] == 0
        oai({**body, "model": f"tiny:{ADAPTERS[0]}"})
        assert oai._lora_engines[ADAPTERS[0]].prefix_model_key == \
            oai.prefix_store.model_key
    finally:
        llm.shutdown()
        oai.shutdown()
        jsrv.engine.shutdown()


# -------------------------------------------------------------- HFTokenizer
@pytest.fixture(scope="module")
def hf_tokenizer_dir(tmp_path_factory):
    """A byte-level BPE trained on a few strings and saved as a transformers
    tokenizer directory: built here, nothing downloaded."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["the quick brown fox jumps over the lazy dog",
              "hello world, serving tokens one at a time",
              "a tokenizer trained on a few strings"] * 20
    tok.train_from_iterator(corpus, trainer)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok,
                                   eos_token="<|endoftext|>")
    path = str(tmp_path_factory.mktemp("hf_tok"))
    fast.save_pretrained(path)
    return path


def test_hf_tokenizer_matches_jax(hf_tokenizer_dir, checkpoint):
    jtok = JS.HFTokenizer(hf_tokenizer_dir)
    ptok = PS.HFTokenizer(hf_tokenizer_dir)
    assert ptok.eos_id == jtok.eos_id == 0
    for text in ("the quick brown fox", "hello world, unseen words too"):
        ids = ptok.encode(text)
        assert ids == jtok.encode(text) and max(ids) < 300
        assert ptok.decode(ids) == jtok.decode(ids) == text
    common = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=96,
                  checkpoint=checkpoint)
    jeng = JS.LLMEngine(model_overrides={"dtype": jnp.float32},
                        weight_store=False, tokenizer=jtok, **common)
    peng = PS.LLMEngine(model_overrides={"dtype": torch.float32},
                        device="cpu", tokenizer=ptok, **common)
    try:
        want = jeng.generate("hello world, serving", max_tokens=6,
                             timeout=TIMEOUT)
        got = peng.generate("hello world, serving", max_tokens=6,
                            timeout=TIMEOUT)
        assert got == want
        assert got["prompt_tokens"] == len(ptok.encode("hello world, serving"))
    finally:
        jeng.shutdown()
        peng.shutdown()
