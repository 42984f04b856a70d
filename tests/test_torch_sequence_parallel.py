"""Training on a mesh with sp (sequence parallel) in the port against the
JAX package's `compile_model_train` on the same mesh.

Ranks are spawned gloo interpreters (`_torch_dist_workers`, each family of
runs once per module); the JAX side runs in this process on virtual CPU
devices. Every run starts from the JAX package's init (f32), carried
across as numpy leaves, and takes 3 steps on a seeded batch of 4 x 33
tokens; the tokens are split over (dp, fsdp) only, as in the JAX package,
and the models' `constrain(..., "seq", ...)` points shard the activations.

- gpt2-tiny with ring attention on dp=2,sp=2 and sp=2,tp=2 (four ranks);
- llama-tiny (grouped-query) on sp=2 with ring and with Ulysses, and
  moe-tiny on sp=2 with ring (two ranks);
- losses and grad norms within atol=1e-5, rtol=1e-4 of JAX, final params
  within 1e-4 (`test_torch_sharded.py`'s bounds); every rank's losses the
  same; in step 2 each rank ran the flash kernels' plain versions once a
  live chunk pair of its sp rank: K1 2 x n_layer x (rank + 1) (the forward
  and the remat recompute), K2 and K3 n_layer x (rank + 1).
"""

import jax
import numpy as np
import pytest

import _torch_dist_workers as W
import test_torch_sharded as S
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS

STEPS = 3
FOUR = [("gpt2", {"dp": 2, "sp": 2}, "ring"),
        ("gpt2", {"sp": 2, "tp": 2}, "ring")]
TWO = [("llama", {"sp": 2}, "ring"), ("llama", {"sp": 2}, "ulysses"),
       ("moe", {"sp": 2}, "ring")]


def _key(name, config, impl):
    return (name, tuple(sorted(config.items())), impl)


def _jax_run(name, config, impl):
    """JAX's compile_model_train on build_mesh(config) with `impl`: (init
    weights, [(loss, grad_norm, step)], final weights)."""
    jmod, cls, preset = S.JAX_FAMILIES[name]
    cfg = getattr(jmod, cls).preset(preset, dtype=jax.numpy.float32,
                                    attn_impl=impl)
    n = int(np.prod(list(config.values())))
    mesh = JM.build_mesh(config, devices=jax.devices()[:n])
    train = JS.compile_model_train(jmod, cfg, mesh,
                                   optimizer=JS.default_optimizer(**S.OPT))
    state = train.init_fn(jax.random.key(0))
    w0 = S._flat(state.params)
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": jax.numpy.asarray(
            S._tokens())})
        hist.append((float(m["loss"]), float(m["grad_norm"]),
                     int(m["step"])))
    return w0, hist, S._flat(state.params)


@pytest.fixture(scope="module")
def jax_runs():
    return {_key(*r): _jax_run(*r) for r in FOUR + TWO}


def _ranks(tmp_path_factory, jax_runs, runs, world):
    tmp = tmp_path_factory.mktemp(f"sp{world}")
    weights = {f"w/{n}/{k}": v for n, c, i in runs
               for k, v in jax_runs[_key(n, c, i)][0].items()}
    np.savez(tmp / "inputs.npz", tokens=S._tokens().astype(np.int64),
             **weights)
    return W.run_ranks(W.sp_trajectory_ranks, world, str(tmp), runs,
                       timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_runs):
    return _ranks(tmp_path_factory, jax_runs, FOUR, 4)


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_runs):
    return _ranks(tmp_path_factory, jax_runs, TWO, 2)


def _check(outs, jax_runs, run):
    name, config, impl = run
    _, jhist, jend = jax_runs[_key(*run)]
    hist, params, _ = outs[0][_key(*run)]
    assert len(hist) == STEPS
    for (gl, gn, gs), (wl, wn, ws) in zip(hist, jhist):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, **S.TOL)
        np.testing.assert_allclose(gn, wn, **S.TOL)
    assert hist[-1][0] < hist[0][0]
    assert set(params) == set(jend)
    for key, arr in params.items():
        np.testing.assert_allclose(arr, jend[key], err_msg=key,
                                   **S.TOL_PARAMS)
    n_layer = W.family(name)[1].n_layer
    dims = [a for a in JM.MESH_AXES if config.get(a, 1) > 1]
    for rank, o in enumerate(outs):
        assert o[_key(*run)][0] == hist
        if impl != "ring":
            continue
        # the sp coordinate of a rank on the row-major mesh
        sp_rank = (rank // int(np.prod([config[a] for a in
                                        dims[dims.index("sp") + 1:]]))
                   ) % config["sp"]
        live = sp_rank + 1
        assert o[_key(*run)][2] == {
            "flash_attention_reference": 2 * n_layer * live,
            "_bwd_dq_reference": n_layer * live,
            "_bwd_dkv_reference": n_layer * live}


@pytest.mark.parametrize("run", FOUR, ids=lambda r: S.run_id(r[0], r[1]))
def test_four_rank_sp_trajectory_matches_jax(four, jax_runs, run):
    _check(four, jax_runs, run)


@pytest.mark.parametrize("run", TWO,
                         ids=lambda r: f"{S.run_id(r[0], r[1])}-{r[2]}")
def test_two_rank_sp_trajectory_matches_jax(two, jax_runs, run):
    _check(two, jax_runs, run)
