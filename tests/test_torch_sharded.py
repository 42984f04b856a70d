"""Sharded training in the port (`build_mesh` meshes of dp, fsdp, tp and ep,
params as DTensors) against the JAX package's `compile_model_train` on the
same mesh and against the port on one device.

Ranks are spawned gloo interpreters (`_torch_dist_workers`), each joined
with its own limit; the JAX side runs in this process on virtual CPU
devices. Every run starts from the JAX package's init (f32), carried across
as numpy leaves, and takes 4 steps on a seeded batch of 4 x 33 tokens:

- four ranks, the 4-device meshes of `__graft_entry__.py`'s dry run that
  this slice covers, `dp=2,tp=2` and `ep=4`, and `fsdp=2,tp=2`: gpt2-tiny
  on both 2 x 2 meshes here; llama-tiny (grouped-query) on both and
  moe-tiny (4 experts) on ep=4 in `test_torch_sharded_llama_moe.py`;
- two ranks, a flat `dp=2` mesh and a `tp=2` mesh (gpt2-tiny), the latter's
  collectives counted for one step;
- losses and grad norms within atol=1e-5, rtol=1e-4 of JAX and of one
  device (sharded sums run in another order), final params within 1e-4,
  `test_torch_train.py`'s trajectory bound: a gradient that cancels to
  near zero takes a full Adam step of its rounding noise (on the flat dp=2
  mesh one wqkv element's first-update gradient is 6.4e-9 against its
  column's median 2.6e-3; one device and JAX already part there by
  2.4e-5);
- the flash kernels' plain versions on each rank's local [B/dp, H/tp, T,
  Dh] shard equal to the unsharded call; chunked cross-entropy on a mesh
  equal to the plain loss; a remat backward run from another thread (as the
  autograd engine runs CUDA tensors') recomputes on the forward's shards;
  `local_window` equal to DTensor's own shards.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu.models import moe as JMoE
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu_torch.train import spmd as PS

TOL = dict(atol=1e-5, rtol=1e-4)
TOL_PARAMS = dict(atol=1e-4, rtol=0)
OPT = dict(lr=1e-3, warmup=2, total_steps=20)
STEPS = 4
JAX_FAMILIES = {"gpt2": (JG, "GPT2Config", "gpt2-tiny"),
                "llama": (JL, "LlamaConfig", "llama-tiny"),
                "moe": (JMoE, "MoEConfig", "moe-tiny")}
FOUR = [("gpt2", {"dp": 2, "tp": 2}), ("gpt2", {"fsdp": 2, "tp": 2})]
TWO = [("gpt2", {"dp": 2}), ("gpt2", {"tp": 2})]
# the collectives of one gpt2-tiny step on a tp=2 mesh, by kind: the QKV
# product's split gathers the three projections whole (the fused weight's
# contiguous tp split gives rank 0 all of Q), the vocab-sharded logits are
# gathered for the cross-entropy, row-parallel products are partial sums,
# and the gradients of replicated params are reduced. A change that adds a
# collective shows here.
TP2_COMM = {"all_gather_into_tensor": 16, "all_reduce": 20,
            "reduce_scatter_tensor": 4}


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _key(name, config):
    return (name, tuple(sorted(config.items())))


def _tokens():
    return np.random.default_rng(9).integers(0, 512, (4, 33)).astype(
        np.int32)


def _jax_run(name, config):
    """JAX's compile_model_train on build_mesh(config): (init weights,
    [(loss, grad_norm, step)], final weights)."""
    jmod, cls, preset = JAX_FAMILIES[name]
    cfg = getattr(jmod, cls).preset(preset, dtype=jax.numpy.float32,
                                    attn_impl="dense")
    n = int(np.prod(list(config.values())))
    mesh = JM.build_mesh(config, devices=jax.devices()[:n])
    train = JS.compile_model_train(jmod, cfg, mesh,
                                   optimizer=JS.default_optimizer(**OPT))
    state = train.init_fn(jax.random.key(0))
    w0 = _flat(state.params)
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": jax.numpy.asarray(
            _tokens())})
        hist.append((float(m["loss"]), float(m["grad_norm"]),
                     int(m["step"])))
    return w0, hist, _flat(state.params)


@pytest.fixture(scope="module")
def jax_runs():
    return {_key(n, c): _jax_run(n, c) for n, c in FOUR + TWO}


def four_ranks(tmp_path_factory, jax_runs, runs, extras):
    tmp = tmp_path_factory.mktemp("mesh4")
    _write_inputs(tmp, jax_runs, runs)
    return W.run_ranks(W.mesh_four_ranks, 4, str(tmp), runs, extras)


def _write_inputs(tmp, jax_runs, runs):
    weights = {f"w/{n}/{k}": v for n, c in runs
               for k, v in jax_runs[_key(n, c)][0].items()}
    np.savez(tmp / "inputs.npz", tokens=_tokens().astype(np.int64),
             **weights)


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_runs):
    return four_ranks(tmp_path_factory, jax_runs, FOUR, True)


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_runs):
    tmp = tmp_path_factory.mktemp("mesh2")
    _write_inputs(tmp, jax_runs, TWO[:1])
    return W.run_ranks(W.mesh_two_ranks, 2, str(tmp))


def _one_device(name, w0):
    mod, cfg = W.family(name, attn_impl="dense")
    opt = PS.default_optimizer(**OPT)
    train = PS.compile_model_train(mod, cfg, optimizer=opt, device="cpu")
    params = mod.params_from_numpy(w0, cfg, device="cpu")
    state = PS.TrainState(0, params, opt.init(params))
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": _tokens()})
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return hist, mod.params_to_numpy(state.params)


def _same_trajectory(got, want):
    (ghist, gparams), (whist, wparams) = got, want
    assert len(ghist) == len(whist) == STEPS
    for (gl, gn, gs), (wl, wn, ws) in zip(ghist, whist):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, **TOL)
        np.testing.assert_allclose(gn, wn, **TOL)
    assert ghist[-1][0] < ghist[0][0]
    assert set(gparams) == set(wparams)
    for key, arr in gparams.items():
        np.testing.assert_allclose(arr, wparams[key], err_msg=key,
                                   **TOL_PARAMS)


def run_id(name, config):
    return f"{name}-{'-'.join(f'{a}{d}' for a, d in config.items())}"


def check_four(four, jax_runs, name, config):
    """The rank-0 trajectory against JAX's and one device's; every rank's
    losses the same."""
    w0, jhist, jend = jax_runs[_key(name, config)]
    hist, params = four[0][_key(name, config)]
    _same_trajectory((hist, params), (jhist, jend))
    _same_trajectory((hist, params), _one_device(name, w0))
    for o in four[1:]:
        assert o[_key(name, config)][0] == hist


@pytest.mark.parametrize("name,config", FOUR,
                         ids=[run_id(n, c) for n, c in FOUR])
def test_four_rank_trajectory_matches_jax_and_one_device(four, jax_runs,
                                                         name, config):
    check_four(four, jax_runs, name, config)


@pytest.mark.parametrize("which", ["dp", "tp"])
def test_two_rank_trajectory_matches_jax_and_one_device(two, jax_runs,
                                                        which):
    config = {which: 2}
    w0, jhist, jend = jax_runs[_key("gpt2", config)]
    _same_trajectory(two[0][which], (jhist, jend))
    _same_trajectory(two[0][which], _one_device("gpt2", w0))
    assert two[1][which][0] == two[0][which][0]


def test_tp_step_collectives_pinned(two):
    for o in two:
        assert o["tp_comm"] == TP2_COMM


def test_flash_plain_path_on_local_head_shards(four):
    for o in four:
        got, want, seen = o["flash"]
        np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)
        # B=4 over dp=2, H=4 over tp=2: K1 forward, K2 and K3 backward
        assert seen == [("flash_attention_reference", (2, 2, 64, 32)),
                        ("_bwd_dq_reference", (2, 2, 64, 32)),
                        ("_bwd_dkv_reference", (2, 2, 64, 32))]


def test_chunked_cross_entropy_on_a_mesh(four):
    (loss, grads), (closs, cgrads) = four[0]["chunked_ce"]
    np.testing.assert_allclose(closs, loss, rtol=1e-6)
    for key, g in grads.items():
        np.testing.assert_allclose(cgrads[key], g, atol=1e-6, rtol=1e-5,
                                   err_msg=key)


def test_recompute_on_another_thread_shards_as_the_forward(four):
    assert all(o["thread_grads"] for o in four)


def test_local_window_is_dtensors_own_shard(four):
    for o in four:
        assert o["windows"] and all(o["windows"])
