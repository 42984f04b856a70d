"""ray_tpu_torch.models.llama against the JAX package on the same weights.

Weights are made by the JAX package (llama.init_params) and carried across as
the path-keyed numpy leaves of `params_from_numpy`; tokens are numpy, from a
seed. Models run in float32 on `llama-tiny` (2 layers, d_model 128, 4 query
heads on 2 KV heads) and on the same preset with one KV head. JAX's flash
attention runs its Pallas kernels in interpret mode on the CPU, the port its
kernels' plain versions.

Tolerances (f32, two layers of f32 arithmetic summed in another order; the
measured gaps are ~1e-6 for logits and ~1e-7 for gradients): logits and
cache atol=1e-4, rtol=1e-4; loss abs 1e-5; gradients atol=1e-5, rtol=1e-4,
as tests/test_torch_train.py holds GPT-2's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as J
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import llama as P
from ray_tpu_torch.ops import flash_attention as PF
from ray_tpu_torch.train import spmd as PS

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)
# n_kv_head 2: grouped-query attention, two query heads per KV head;
# 1: every query head on one KV head
KV_HEADS = [2, 1]


def _jcfg(**kw):
    return J.LlamaConfig.preset("llama-tiny", dtype=jnp.float32, **kw)


def _pcfg(**kw):
    return P.LlamaConfig.preset("llama-tiny", dtype=torch.float32, **kw)


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _tokens(B, T, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _weights(**arch):
    """(JAX params, their flat numpy leaves) for llama-tiny with `arch`."""
    jp = J.init_params(jax.random.key(0), _jcfg(**arch))
    return jp, _flat(jp)


@pytest.mark.parametrize("kv", KV_HEADS)
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_matches_jax(kv, attn_impl):
    # T=64: JAX's flash kernel takes one 64-row block (its divisibility
    # contract: T % min(128, T) == 0)
    jp, flat = _weights(n_kv_head=kv)
    kw = dict(n_kv_head=kv, attn_impl=attn_impl, remat=False)
    toks = _tokens(2, 64)
    want = np.asarray(J.forward(jp, jnp.asarray(toks), _jcfg(**kw)))
    params = P.params_from_numpy(flat, _pcfg(**kw), device="cpu")
    got = P.forward(params, torch.from_numpy(toks), _pcfg(**kw))
    assert got.shape == (2, 64, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tied_embeddings_forward_matches_jax():
    jp, flat = _weights(tie_embeddings=True)
    assert "lm_head" not in flat
    kw = dict(tie_embeddings=True, attn_impl="dense", remat=False)
    toks = _tokens(2, 16, seed=2)
    want = np.asarray(J.forward(jp, jnp.asarray(toks), _jcfg(**kw)))
    params = P.params_from_numpy(flat, _pcfg(**kw), device="cpu")
    got = P.forward(params, torch.from_numpy(toks), _pcfg(**kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _port_grads(flat, pcfg, toks):
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    leaves = P._gpt2._flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss = P.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("kv", KV_HEADS)
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_loss_grads_match_jax(kv, remat, attn_impl):
    # dK and dV of the flash kernels are per query head; autograd sums them
    # over each group, as the transpose of JAX's broadcast does
    jp, flat = _weights(n_kv_head=kv)
    kw = dict(n_kv_head=kv, attn_impl=attn_impl, remat=remat)
    toks = _tokens(2, 33)
    jl, jg = jax.value_and_grad(J.loss_fn)(jp, {"tokens": jnp.asarray(toks)},
                                          _jcfg(**kw))
    loss, grads = _port_grads(flat, _pcfg(**kw), toks)
    assert loss.item() == pytest.approx(float(jl), abs=1e-5)
    want = _flat(jg)
    assert set(grads) == set(want)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[key], **TOL_GRAD,
                                   err_msg=key)


def test_bf16_forward_and_grads_close_to_jax():
    # bf16 compute, flash attention: both frameworks cast the f32 params to
    # bf16 for each product but round at other places. Logits within 2e-2
    # (their scale here is ~0.1; one bf16 step at 0.1 is 5e-4, and two
    # layers' roundings add a few); each gradient leaf within 5 % of its own
    # largest entry, as tests/test_torch_train.py bounds GPT-2's
    jp, flat = _weights()
    toks = _tokens(2, 65, seed=3)
    jcfg = J.LlamaConfig.preset("llama-tiny", attn_impl="flash", remat=False)
    pcfg = P.LlamaConfig.preset("llama-tiny", attn_impl="flash", remat=False)
    want = np.asarray(J.forward(jp, jnp.asarray(toks[:, :-1]), jcfg)
                      .astype(jnp.float32))
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    got = P.forward(params, torch.from_numpy(toks[:, :-1]), pcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)
    jl, jg = jax.value_and_grad(J.loss_fn)(jp, {"tokens": jnp.asarray(toks)},
                                          jcfg)
    loss, grads = _port_grads(flat, pcfg, toks)
    assert loss.item() == pytest.approx(float(jl), abs=2e-2)
    want = _flat(jg)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=0.05 * scale + 1e-6, err_msg=key)


@pytest.mark.parametrize("remat,per_layer", [(False, 1), (True, 2)])
def test_flash_forward_reruns_under_remat(monkeypatch, remat, per_layer):
    # under remat each block, K1 included, runs again in the backward pass:
    # a training step launches 2 * n_layer K1, and n_layer K2 and K3
    _, flat = _weights()
    calls = []
    real = PF.flash_attention_reference
    monkeypatch.setattr(PF, "flash_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _pcfg(attn_impl="flash", remat=remat)
    _port_grads(flat, cfg, _tokens(2, 33, seed=5))
    assert len(calls) == per_layer * cfg.n_layer


def test_expand_kv_gives_query_head_its_group():
    # query head h reads KV head h // q_per_kv (JAX's broadcast), not
    # h % n_kv_head (a tile): a check that one KV head would not make
    B, T, KV, G, Dh = 1, 3, 3, 2, 4
    k = torch.arange(B * T * KV * Dh, dtype=torch.float32).reshape(
        B, T, KV, Dh)
    out = P.expand_kv(k, G)
    assert out.shape == (B, T, KV * G, Dh)
    for h in range(KV * G):
        assert torch.equal(out[:, :, h], k[:, :, h // G])
    jk = jnp.broadcast_to(jnp.asarray(k.numpy())[:, :, :, None],
                          (B, T, KV, G, Dh)).reshape(B, T, KV * G, Dh)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jk))


def test_rope_matches_jax():
    pos = np.arange(0, 4096, 37, dtype=np.int32)
    for theta in (10000.0, 500000.0):
        jc, js = J.rope_freqs(jnp.asarray(pos), 128, theta)
        pc, ps = P.rope_freqs(torch.from_numpy(pos), 128, theta)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 8)).astype(
        np.float32)
    jc, js = J.rope_freqs(jnp.arange(5), 8, 10000.0)
    pc, ps = P.rope_freqs(torch.arange(5), 8, 10000.0)
    want = J.apply_rope(jnp.asarray(x), jc[None, :, None], js[None, :, None])
    got = P.apply_rope(torch.from_numpy(x), pc[None, :, None],
                       ps[None, :, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------------------------------- decode


@pytest.mark.parametrize("kv", KV_HEADS)
def test_decode_step_matches_jax(kv):
    # slot 1 is inactive on odd steps: its cache must not move there. The
    # cache is longer than the steps taken, so later positions stay zero
    jp, flat = _weights(n_kv_head=kv)
    B, T, L = 2, 10, 16
    jcfg = _jcfg(n_kv_head=kv, remat=False)
    pcfg = _pcfg(n_kv_head=kv, remat=False)
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    toks = _tokens(B, T, seed=6)
    jcache = J.init_cache(jcfg, B, max_len=L)
    pcache = P.init_cache(pcfg, B, max_len=L, device="cpu")
    assert pcache["k"].shape == jcache["k"].shape == (2, B, kv, L, 32)
    pos = np.zeros(B, np.int32)
    for i in range(T):
        active = np.array([True, i % 2 == 0])
        jl, jcache = J.decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                   jnp.asarray(pos), jnp.asarray(active),
                                   jcfg)
        pl, pcache = P.decode_step(params, pcache,
                                   torch.from_numpy(toks[:, i]),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(active), pcfg)
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(pl[0].numpy(), np.asarray(jl)[0], **TOL)
        if active[1]:
            np.testing.assert_allclose(pl[1].numpy(), np.asarray(jl)[1],
                                       **TOL)
        pos = pos + active
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_decode_clamps_positions_past_the_cache_like_jax():
    # JAX's dynamic_update_slice clamps a write at pos >= T to T - 1, and
    # the mask lets such a row see the whole cache: the port does the same
    jp, flat = _weights()
    jcfg, pcfg = _jcfg(remat=False), _pcfg(remat=False)
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    toks = _tokens(2, 6, seed=7)
    jcache = J.init_cache(jcfg, 2, max_len=4)
    pcache = P.init_cache(pcfg, 2, max_len=4, device="cpu")
    for i in range(6):
        pos = np.array([i, min(i, 2)], np.int32)
        active = np.array([True, True])
        jl, jcache = J.decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                   jnp.asarray(pos), jnp.asarray(active),
                                   jcfg)
        pl, pcache = P.decode_step(params, pcache,
                                   torch.from_numpy(toks[:, i]),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(active), pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_decode_matches_forward():
    # the JAX package's test_llama_gqa_decode_matches_forward, on the port
    _, flat = _weights()
    cfg = _pcfg(remat=False)
    params = P.params_from_numpy(flat, cfg, device="cpu")
    B, T = 2, 12
    toks = torch.from_numpy(_tokens(B, T, seed=3))
    full = P.forward(params, toks, cfg)
    cache = P.init_cache(cfg, B, max_len=T, device="cpu")
    outs = []
    for i in range(T):
        logits, cache = P.decode_step(params, cache, toks[:, i],
                                      torch.full((B,), i),
                                      torch.ones(B, dtype=torch.bool), cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- params


@pytest.mark.parametrize("arch", [{}, dict(n_kv_head=1),
                                  dict(tie_embeddings=True)])
def test_params_roundtrip_bitwise_and_shapes(arch):
    _, flat = _weights(**arch)
    cfg = _pcfg(**arch)
    assert {k: v.shape for k, v in flat.items()} == P.param_shapes(cfg)
    back = P.params_to_numpy(P.params_from_numpy(flat, cfg, device="cpu"))
    assert list(back) == list(flat)
    for key in flat:
        assert back[key].dtype == flat[key].dtype
        np.testing.assert_array_equal(back[key], flat[key])
    mine = P.params_to_numpy(P.init_params(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
    assert {k: v.shape for k, v in mine.items()} == P.param_shapes(cfg)
    assert sum(v.size for v in mine.values()) == P.num_params(cfg)


def test_params_from_numpy_checks_shapes():
    _, flat = _weights()
    with pytest.raises(ValueError, match="keys differ"):
        P.params_from_numpy({k: v for k, v in flat.items() if k != "lm_head"},
                            _pcfg(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        P.params_from_numpy(flat, _pcfg(n_kv_head=1), device="cpu")


def test_init_draws_like_jax():
    # other random numbers than JAX's, the same distribution per leaf
    cfg = _pcfg()
    mine = P.params_to_numpy(P.init_params(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
    _, want = _weights()
    for key, arr in want.items():
        if key.endswith("scale"):
            np.testing.assert_array_equal(mine[key], arr)
        else:
            assert mine[key].std() == pytest.approx(float(arr.std()),
                                                    rel=0.1), key


@pytest.mark.parametrize("preset", ["llama2-7b", "llama2-13b", "llama3-8b",
                                    "tinyllama-1.1b", "llama-tiny"])
def test_num_params_and_config_match_jax(preset):
    jc, pc = J.LlamaConfig.preset(preset), P.LlamaConfig.preset(preset)
    assert P.num_params(pc) == J.num_params(jc)
    assert (pc.head_dim, pc.q_per_kv) == (jc.head_dim, jc.q_per_kv)
    for f in dataclasses.fields(J.LlamaConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert {f.name for f in dataclasses.fields(J.LlamaConfig)} == \
        {f.name for f in dataclasses.fields(P.LlamaConfig)}
    assert (pc.dtype, pc.param_dtype) == (torch.bfloat16, torch.float32)


def test_ring_and_ulysses_raise():
    # they no longer raise: with no mesh (or sp == 1) ring and Ulysses are
    # dense reference attention, the JAX package's rule, so the forward
    # equals the dense one
    _, flat = _weights()
    toks = torch.from_numpy(_tokens(2, 16)).long()
    dense = _pcfg(attn_impl="dense", remat=False)
    want = P.forward(P.params_from_numpy(flat, dense, device="cpu"), toks,
                     dense)
    for impl in ("ring", "ulysses"):
        cfg = _pcfg(attn_impl=impl, remat=False)
        params = P.params_from_numpy(flat, cfg, device="cpu")
        got = P.forward(params, toks, cfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=1e-4)


def test_entry_points_default_to_cuda():
    cfg = _pcfg()
    if torch.cuda.is_available():
        assert P.init_cache(cfg, 1)["k"].device.type == "cuda"
        return
    _, flat = _weights()
    for call in (lambda: P.init_params(torch.Generator(), cfg),
                 lambda: P.params_from_numpy(flat, cfg),
                 lambda: P.init_cache(cfg, 1),
                 lambda: PS.compile_model_train(P, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------- training


def _jax_run(cfg, batch, steps, opt_kw):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    train = JS.compile_model_train(J, cfg, mesh,
                                   optimizer=JS.default_optimizer(**opt_kw))
    state = train.init_fn(jax.random.key(0))
    params0 = _flat(state.params)
    hist = []
    for _ in range(steps):
        state, m = train.step_fn(state, {"tokens": jnp.asarray(batch)})
        hist.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    return params0, hist, _flat(state.params)


@pytest.mark.parametrize("kw", [
    dict(attn_impl="dense", remat=False),
    dict(attn_impl="flash", remat=True),
], ids=["dense-noremat", "flash-remat"])
def test_compile_model_train_trajectory_matches_jax(kw):
    # as GPT-2's trajectory test: lr 1e-3, a 2-step warmup (the first update
    # has lr 0); loss and grad norm agree to f32 rounding through 6 steps,
    # params to a tenth of one peak-lr step (Adam turns the rounding of a
    # gradient that cancels to near zero into a step of full size)
    batch = _tokens(4, 33, seed=9)
    opt_kw = dict(lr=1e-3, warmup=2, total_steps=20)
    params0, want, want_params = _jax_run(_jcfg(**kw), batch, 6, opt_kw)
    pcfg = _pcfg(**kw)
    train = PS.compile_model_train(P, pcfg, optimizer=PS.default_optimizer(
        **opt_kw), device="cpu")
    params = P.params_from_numpy(params0, pcfg, device="cpu")
    state = PS.TrainState(0, params, PS.default_optimizer(**opt_kw).init(
        params))
    got = []
    for _ in range(6):
        state, m = train.step_fn(state, {"tokens": batch})
        got.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    for (gl, gn, gs), (wl, wn, ws) in zip(got, want):
        assert gs == ws
        assert gl == pytest.approx(wl, abs=1e-5)
        assert gn == pytest.approx(wn, rel=1e-4)
    assert got[0][0] == got[1][0]           # the first update has lr 0
    assert got[-1][0] < got[0][0]
    for key, arr in P.params_to_numpy(state.params).items():
        np.testing.assert_allclose(arr, want_params[key], atol=1e-4, rtol=0,
                                   err_msg=key)


def test_loss_decreases_through_init_fn():
    # the JAX package's test_llama_loss_decreases, on the port, from the
    # port's own init
    cfg = _pcfg(remat=False)
    train = PS.compile_model_train(P, cfg, optimizer=PS.default_optimizer(
        lr=1e-2, warmup=2, total_steps=30), device="cpu")
    state = train.init_fn(torch.Generator().manual_seed(0))
    batch = {"tokens": _tokens(4, 33, seed=0)}
    losses = []
    for _ in range(12):
        state, m = train.step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
