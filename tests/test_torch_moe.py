"""ray_tpu_torch.models.moe against the JAX package on the same weights.

Weights are made by the JAX package (moe.init_params) on `moe-tiny` (2
layers, d_model 128, 4 experts, top-2, 4 query heads on 2 KV heads) and
carried across as path-keyed numpy leaves; inputs are numpy, from a seed;
everything runs in float32.

Tolerances (f32, as tests/test_torch_llama.py): logits, layer outputs and
the aux losses atol=1e-4, rtol=1e-4; loss abs 1e-5; gradients atol=1e-5,
rtol=1e-4. The routing decisions are held exactly: the top-k indices (ties
have probability zero on random f32 inputs, so torch.topk and lax.top_k
choose alike) and dropped_frac, a count of dropped slots.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as J
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import moe as P
from ray_tpu_torch.train import spmd as PS

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)
TOL_SCALAR = dict(abs=1e-4, rel=1e-4)
AUX = ("aux_loss", "z_loss", "dropped_frac")


def _jcfg(**kw):
    return J.MoEConfig.preset("moe-tiny", dtype=jnp.float32, **kw)


def _pcfg(**kw):
    return P.MoEConfig.preset("moe-tiny", dtype=torch.float32, **kw)


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _tokens(B, T, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def weights():
    jp = J.init_params(jax.random.key(0), _jcfg())
    return jp, _flat(jp)


def _layer_inputs(weights, B=2, T=32, seed=4, x_scale=1.0):
    """One layer's MoE params (JAX and port) and a normal x [B, T, D]."""
    jp, flat = weights
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    pmoe = {k.split("/")[-1]: torch.from_numpy(v[0])
            for k, v in flat.items() if k.startswith("blocks/moe/")}
    x = (np.random.default_rng(seed).standard_normal((B, T, 128)) * x_scale
         ).astype(np.float32)
    return jmoe, pmoe, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0],
                         ids=["default", "drops", "no-drops"])
def test_moe_layer_matches_jax(weights, capacity_factor):
    # capacity 0.5: C = max(ceil(2 * 32 * 0.5 / 4), 4) = 8 places for the 16
    # slots an expert gets on average, so about half the slots drop
    jmoe, pmoe, x = _layer_inputs(weights)
    jcfg = _jcfg(capacity_factor=capacity_factor)
    pcfg = _pcfg(capacity_factor=capacity_factor)
    jout, jaux = J.moe_layer(jnp.asarray(x), jmoe, jcfg)
    pout, paux = P.moe_layer(torch.from_numpy(x), pmoe, pcfg)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    for key in ("aux_loss", "z_loss"):
        assert paux[key].item() == pytest.approx(float(jaux[key]),
                                                    **TOL_SCALAR)
    assert paux["dropped_frac"].item() == float(jaux["dropped_frac"])
    dropped = paux["dropped_frac"].item()
    if capacity_factor == 0.5:
        assert dropped > 0.2
    elif capacity_factor == 8.0:
        assert dropped == 0.0


def test_routing_matches_jax(weights):
    # the top-k choices, gates and probabilities of moe_layer's router
    jmoe, pmoe, x = _layer_inputs(weights, seed=5, x_scale=4.0)
    logits = jnp.asarray(x) @ jmoe["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    jvals, jidx = jax.lax.top_k(probs, 2)
    jvals = jvals / jnp.sum(jvals, axis=-1, keepdims=True)
    plogits, pprobs, pvals, pidx = P.route(torch.from_numpy(x), pmoe,
                                           _pcfg())
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pvals.numpy(), np.asarray(jvals), **TOL)
    np.testing.assert_allclose(pprobs.numpy(), np.asarray(probs), **TOL)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(logits), **TOL)
    # the choices are not all alike: several experts win
    assert len(np.unique(pidx.numpy()[..., 0])) > 1


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_and_aux_match_jax(weights, attn_impl):
    jp, flat = weights
    kw = dict(attn_impl=attn_impl, remat=False)
    toks = _tokens(2, 64)
    jl, jaux = J.forward(jp, jnp.asarray(toks), _jcfg(**kw), return_aux=True)
    params = P.params_from_numpy(flat, _pcfg(**kw), device="cpu")
    pl, paux = P.forward(params, torch.from_numpy(toks), _pcfg(**kw),
                         return_aux=True)
    assert pl.shape == (2, 64, 512)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    assert set(paux) == set(jaux) == set(AUX)
    for key in ("aux_loss", "z_loss"):
        assert paux[key].item() == pytest.approx(float(jaux[key]),
                                                    **TOL_SCALAR)
    assert paux["dropped_frac"].item() == float(jaux["dropped_frac"])
    assert torch.equal(P.forward(params, torch.from_numpy(toks), _pcfg(**kw)),
                       pl)


def _port_grads(flat, pcfg, toks):
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    leaves = P._gpt2._flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss = P.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_loss_grads_match_jax(weights, attn_impl, remat, capacity_factor):
    # the loss is ce + 0.01 * aux + 1e-3 * z; the aux dict rides through
    # the remat'd block. Gradients reach the router through the gates, the
    # load-balance loss and the z-loss
    jp, flat = weights
    kw = dict(attn_impl=attn_impl, remat=remat,
              capacity_factor=capacity_factor)
    toks = _tokens(2, 33)
    jl, jg = jax.value_and_grad(J.loss_fn)(jp, {"tokens": jnp.asarray(toks)},
                                          _jcfg(**kw))
    loss, grads = _port_grads(flat, _pcfg(**kw), toks)
    assert loss.item() == pytest.approx(float(jl), abs=1e-5)
    want = _flat(jg)
    assert set(grads) == set(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], **TOL_GRAD,
                                   err_msg=key)
    assert float(np.abs(want["blocks/moe/router"]).max()) > 0


def test_params_roundtrip_bitwise_and_shapes(weights):
    _, flat = weights
    cfg = _pcfg()
    assert {k: v.shape for k, v in flat.items()} == P.param_shapes(cfg)
    back = P.params_to_numpy(P.params_from_numpy(flat, cfg, device="cpu"))
    assert list(back) == list(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    mine = P.params_to_numpy(P.init_params(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
    assert {k: v.shape for k, v in mine.items()} == P.param_shapes(cfg)
    assert sum(v.size for v in mine.values()) == P.num_params(cfg)


@pytest.mark.parametrize("preset", ["mixtral-8x7b", "moe-tiny"])
def test_counts_and_config_match_jax(preset):
    jc, pc = J.MoEConfig.preset(preset), P.MoEConfig.preset(preset)
    assert P.num_params(pc) == J.num_params(jc)
    assert P.active_params(pc) == J.active_params(jc)
    for n in (1, 16, 33, 2048, 4096):
        assert P.expert_capacity(pc, n) == J.expert_capacity(jc, n)
    for f in dataclasses.fields(J.MoEConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert {f.name for f in dataclasses.fields(J.MoEConfig)} == \
        {f.name for f in dataclasses.fields(P.MoEConfig)}
    assert (pc.capacity_factor, pc.aux_loss_weight, pc.z_loss_weight) == \
        (1.25, 0.01, 1e-3)


def test_compile_model_train_trajectory_matches_jax():
    # the generic entry point, unchanged, on the MoE family: 4 steps as the
    # Llama trajectory test holds them
    batch = _tokens(4, 33, seed=9)
    opt_kw = dict(lr=1e-3, warmup=2, total_steps=20)
    kw = dict(attn_impl="dense", remat=True)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrain = JS.compile_model_train(J, _jcfg(**kw), mesh,
                                    optimizer=JS.default_optimizer(**opt_kw))
    jstate = jtrain.init_fn(jax.random.key(0))
    pcfg = _pcfg(**kw)
    params = P.params_from_numpy(_flat(jstate.params), pcfg, device="cpu")
    train = PS.compile_model_train(P, pcfg, optimizer=PS.default_optimizer(
        **opt_kw), device="cpu")
    state = PS.TrainState(0, params, PS.default_optimizer(**opt_kw).init(
        params))
    losses = []
    for _ in range(4):
        jstate, jm = jtrain.step_fn(jstate, {"tokens": jnp.asarray(batch)})
        state, m = train.step_fn(state, {"tokens": batch})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-4)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for key, arr in P.params_to_numpy(state.params).items():
        np.testing.assert_allclose(arr, _flat(jstate.params)[key], atol=1e-4,
                                   rtol=0, err_msg=key)


def test_entry_points_default_to_cuda(weights):
    cfg = _pcfg()
    if torch.cuda.is_available():
        return
    _, flat = weights
    for call in (lambda: P.init_params(torch.Generator(), cfg),
                 lambda: P.params_from_numpy(flat, cfg),
                 lambda: PS.compile_model_train(P, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
