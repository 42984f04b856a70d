"""The port's training path against the JAX package.

- GPT-2 loss gradients (`jax.grad(gpt2.loss_fn)` against autograd through
  the port) for every attention, remat and ce_chunk setting;
- what each remat policy recomputes;
- `default_optimizer` against optax, step by step;
- a `compile_gpt2_train` trajectory against JAX's on a one-device CPU mesh.

Weights are made by the JAX package and carried across as the path-keyed
numpy leaves of `params_from_numpy`; batches are numpy, from a seed. Models
run in float32 on `gpt2-tiny` (2 layers, d_model 128) unless a test says
otherwise. The f32 gradient tolerance is atol=1e-5, rtol=1e-4: two layers of
f32 arithmetic summed in another order (the measured gap is ~2e-7).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt2 as J
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import gpt2 as P
from ray_tpu_torch.ops import flash_attention as PF
from ray_tpu_torch.train import spmd as PS

TOL = dict(atol=1e-5, rtol=1e-4)
REMAT = {"off": dict(remat=False), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots"),
         "dots_all": dict(remat=True, remat_policy="dots_all")}


def _jcfg(**kw):
    return J.GPT2Config.preset("gpt2-tiny", dtype=jnp.float32, **kw)


def _pcfg(**kw):
    return P.GPT2Config.preset("gpt2-tiny", dtype=torch.float32, **kw)


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def weights():
    jp = J.init_params(jax.random.key(0), _jcfg())
    return jp, _flat(jp)


def _tokens(B, T, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _port_grads(flat, pcfg, toks):
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    leaves = P._flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss = P.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("ce_chunk", [0, 32])
@pytest.mark.parametrize("remat", list(REMAT))
@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_loss_grads_match_jax(weights, attn_impl, remat, ce_chunk):
    jp, flat = weights
    kw = dict(attn_impl=attn_impl, ce_chunk=ce_chunk, **REMAT[remat])
    toks = _tokens(2, 65)
    jl, jg = jax.value_and_grad(J.loss_fn)(jp, {"tokens": jnp.asarray(toks)},
                                          _jcfg(**kw))
    loss, grads = _port_grads(flat, _pcfg(**kw), toks)
    assert loss.item() == pytest.approx(float(jl), abs=1e-5)
    want = _flat(jg)
    assert set(grads) == set(want)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[key], **TOL, err_msg=key)


def test_bf16_grads_close_to_jax(weights):
    # bf16 compute: both frameworks cast the f32 params to bf16 for each
    # product, so the gradients come back f32 through the cast, but they
    # round at other places. Bound each leaf's error by its own scale.
    jp, flat = weights
    toks = _tokens(2, 65, seed=3)
    jcfg = J.GPT2Config.preset("gpt2-tiny", attn_impl="flash", remat=False)
    pcfg = P.GPT2Config.preset("gpt2-tiny", attn_impl="flash", remat=False)
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


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(flat, pcfg, toks):
    params = P.params_from_numpy(flat, pcfg, device="cpu")
    leaves = list(P._flatten(params).values())
    for leaf in leaves:
        leaf.requires_grad_()
    loss = P.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    with _OpCount() as ops:
        torch.autograd.grad(loss, leaves)
    return ops.n


def test_remat_policies_recompute_what_jax_does(weights):
    # dense attention: the x @ W products run as mm, the attention products
    # as bmm. The backward pass alone (remat off) sets the baseline; "full"
    # recomputes both kinds, "dots" only the batched ones (JAX's
    # dots_with_no_batch_dims_saveable), "dots_all" neither
    _, flat = weights
    toks = _tokens(2, 33, seed=4)
    n = {name: _backward_ops(flat, _pcfg(attn_impl="dense", **kw), toks)
         for name, kw in REMAT.items()}
    base = n["off"]
    assert n["full"]["mm"] > base["mm"] and n["full"]["bmm"] > base["bmm"]
    assert n["dots"]["mm"] == base["mm"] and n["dots"]["bmm"] > base["bmm"]
    assert n["dots_all"]["mm"] == base["mm"]
    assert n["dots_all"]["bmm"] == base["bmm"]


@pytest.mark.parametrize("remat,per_layer", [("off", 1), ("dots", 2)])
def test_flash_forward_reruns_under_remat(weights, monkeypatch, remat,
                                          per_layer):
    # the flash kernel is opaque to a selective policy, as the pallas_call
    # is to jax.checkpoint: under remat its forward runs again in the
    # backward pass, once per layer
    _, flat = weights
    calls = []
    real = PF.flash_attention_reference
    monkeypatch.setattr(PF, "flash_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _pcfg(attn_impl="flash", **REMAT[remat])
    _port_grads(flat, cfg, _tokens(2, 33, seed=5))
    assert len(calls) == per_layer * cfg.n_layer


def test_remat_rejects_unknown_policy(weights):
    _, flat = weights
    with pytest.raises(ValueError, match="remat_policy"):
        _port_grads(flat, _pcfg(remat_policy="everything"), _tokens(1, 9))


def test_chunked_ce_rejects_indivisible_seq(weights):
    _, flat = weights
    with pytest.raises(ValueError, match="ce_chunk"):
        _port_grads(flat, _pcfg(ce_chunk=7), _tokens(1, 33))


def test_layers_are_one_unbind_per_leaf():
    cfg = _pcfg()
    params = P.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    wqkv = params["blocks"]["attn"]["wqkv"].requires_grad_()
    layers = P._layers(params["blocks"])
    assert len(layers) == cfg.n_layer
    for i, bp in enumerate(layers):
        assert bp["attn"]["wqkv"].grad_fn.name() == "UnbindBackward0"
        assert torch.equal(bp["attn"]["wqkv"], wqkv[i])
        assert bp["mlp"]["wi"].data_ptr() == \
            params["blocks"]["mlp"]["wi"][i].data_ptr()


@pytest.mark.parametrize("preset", ["gpt2-125m", "gpt2-350m", "gpt2-tiny"])
def test_flops_per_token_matches_jax(preset):
    assert P.flops_per_token(P.GPT2Config.preset(preset), 1024) == \
        J.flops_per_token(J.GPT2Config.preset(preset), 1024)


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("args", [(0.0, 3e-4, 2, 10), (0.0, 6e-4, 0, 5),
                                  (1e-5, 1e-3, 5, 20)])
def test_schedule_matches_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = PS.warmup_cosine_decay_schedule(*args)
    for count in range(args[3] + 3):
        # float32 throughout; cos may differ by a float32 ulp (6e-8), which
        # 1 + cos carries to the value as a few ulps of the peak
        assert float(got(count)) == pytest.approx(float(want(count)),
                                                  rel=0, abs=3e-7 * args[1])
    if args == (0.0, 3e-4, 2, 10):
        assert [float(got(c)) for c in (0, 10)] == [0.0, 0.0]
        assert float(got(1)) == pytest.approx(1.5e-4, rel=1e-6)
        assert float(got(2)) == pytest.approx(3e-4, rel=1e-6)


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (10.0, True)])
def test_default_optimizer_matches_optax(grad_scale, clipped):
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2)}}

    def draw(scale=1.0):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw()
    kw = dict(lr=1e-2, weight_decay=0.1, warmup=3, total_steps=10)
    jopt, popt = JS.default_optimizer(**kw), PS.default_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    pp = jax.tree.map(torch.tensor, params)
    pstate = popt.init(pp)
    for _ in range(10):
        g = draw(grad_scale)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        g_norm = popt.update(pp, jax.tree.map(torch.tensor, g), pstate)
        want_norm = float(optax.global_norm(g))
        assert float(g_norm) == pytest.approx(want_norm, rel=1e-6)
        assert (want_norm >= 1.0) == clipped
        adam = jstate[1][0]
        # bit-equal without the clip; with it, both divide by a g_norm that
        # they summed in another order (an ulp apart), and a moment that
        # cancels to a small value keeps that ulp of its terms' scale (1e-2)
        for got, want in [(pp, jp), (pstate.mu, adam.mu), (pstate.nu, adam.nu)]:
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-8)
    assert pstate.count == int(adam.count) == 10


# ------------------------------------------------------------- trajectory


def _jax_run(cfg, batch, steps, opt_kw):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    train = JS.compile_gpt2_train(cfg, mesh,
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
    dict(attn_impl="flash", remat=True, remat_policy="dots", ce_chunk=16),
], ids=["dense-noremat", "flash-dots-ce16"])
def test_compile_gpt2_train_trajectory_matches_jax(kw):
    # lr 1e-3 with a 2-step warmup: the first update has lr 0, grad norms
    # start above the clip of 1.0. Loss and grad norm agree to f32 rounding
    # through 6 steps. Params agree to a tenth of one peak-lr step (1e-4):
    # Adam's m / sqrt(v) turns the rounding of a gradient that cancels to
    # near zero into a step of full size. The key bias is the plain case:
    # softmax ignores a shift shared by all keys, so its gradient is zero
    # but for rounding, and both packages step it by normalised noise
    # (measured: up to 8e-6 on bqkv, 2.5e-5 on one wqkv element)
    batch = _tokens(4, 33, seed=9)
    opt_kw = dict(lr=1e-3, warmup=2, total_steps=20)
    params0, want, want_params = _jax_run(_jcfg(**kw), batch, 6, opt_kw)
    pcfg = _pcfg(**kw)
    train = PS.compile_gpt2_train(pcfg, optimizer=PS.default_optimizer(
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


def _small_train(**cfg_kw):
    cfg = _pcfg(**cfg_kw)
    opt = PS.default_optimizer(lr=1e-2, warmup=2, total_steps=30)
    return PS.compile_gpt2_train(cfg, optimizer=opt, device="cpu")


def test_loss_decreases_single_device():
    # the JAX package's test_loss_decreases_single_device, on the port
    train = _small_train(remat=False)
    state = train.init_fn(torch.Generator().manual_seed(0))
    batch = {"tokens": _tokens(4, 33, seed=0)}
    losses = []
    for _ in range(15):
        state, m = train.step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert state.step == 15 == state.opt_state.count


def test_grad_fn_then_apply_fn_equals_step_fn():
    batch = {"tokens": torch.from_numpy(_tokens(2, 33, seed=2))}
    finals = []
    for split in (False, True):
        train = _small_train(attn_impl="flash", remat=True,
                             remat_policy="dots")
        state = train.init_fn(torch.Generator().manual_seed(1))
        for _ in range(3):
            if split:
                loss, grads = train.grad_fn(state, batch)
                assert set(P._flatten(grads)) == set(P._flatten(state.params))
                state = train.apply_fn(state, grads)
            else:
                state, _ = train.step_fn(state, batch)
        finals.append(P.params_to_numpy(state.params))
    for key in finals[0]:
        np.testing.assert_array_equal(finals[0][key], finals[1][key])


def test_step_updates_state_in_place():
    train = _small_train()
    state = train.init_fn(torch.Generator().manual_seed(0))
    wte = state.params["wte"]
    before = wte.clone()
    opt_state = state.opt_state
    for _ in range(2):   # the first update has lr 0 and leaves wte as is
        state, metrics = train.step_fn(state, {"tokens": _tokens(2, 17)})
    assert state.params["wte"] is wte and state.opt_state is opt_state
    assert not torch.equal(wte, before)
    assert not wte.requires_grad and metrics["step"] == 2
    assert metrics["loss"].requires_grad is False


def test_compile_refuses_a_mesh_of_several_devices():
    cfg = _pcfg()
    with pytest.raises(NotImplementedError, match="one process a device"):
        PS.compile_gpt2_train(cfg, mesh=["cpu", "cpu"])
    train = PS.compile_gpt2_train(cfg, mesh=["cpu"])
    assert train.device == torch.device("cpu")


def test_train_entry_point_defaults_to_cuda():
    cfg = _pcfg()
    if torch.cuda.is_available():
        assert PS.compile_gpt2_train(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.compile_gpt2_train(cfg)


def test_config_defaults_match_jax():
    jc, pc = J.GPT2Config(), P.GPT2Config()
    for f in ("remat", "remat_policy", "ce_chunk", "attn_impl"):
        assert getattr(pc, f) == getattr(jc, f), f
    assert {f.name for f in dataclasses.fields(J.GPT2Config)} == \
        {f.name for f in dataclasses.fields(P.GPT2Config)}
