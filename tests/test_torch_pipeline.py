"""GPipe pipeline parallelism in the port (`ray_tpu_torch/parallel/
pipeline.py`, `train/spmd.compile_pipeline_train`) against the JAX
package's (`ray_tpu/parallel/pipeline.py`, `train/spmd.py`) on the same
seeded weights and tokens.

The JAX side runs in this process on virtual CPU devices; the port's
stages run either in this process (virtual stages, one device) or on
spawned gloo ranks (`_torch_dist_workers.pipeline_ranks`, four ranks and
two, once per module each). Models are the JAX pipeline tests' own:
gpt2-tiny at 4 layers and llama-tiny, f32, no remat; 4 microbatches of a
seeded 8 x 17 token batch; weights are JAX's init, carried as numpy.

- the pipelined forward (embed -> pipeline_apply -> unembed) against JAX's
  `pipeline_apply` on the same mesh and against the port's sequential
  forward, within atol=rtol=2e-4 (`tests/test_pipeline.py`'s bound):
  virtual pp=2 and pp=4; gpt2 on pp=2,tp=2, pp=2,dp=2, pp=2,fsdp=2,
  pp=2,ep=2 and pp=2,sp=2 (ring, and Ulysses), llama on pp=2,dp=2 and
  pp=2,sp=2 (ring) as gloo ranks;
- 5 steps of `compile_pipeline_train` against JAX's on the same mesh
  (pp=2, pp=2,dp=2, pp=2,tp=2, pp=2,fsdp=2, pp=2,ep=2 and pp=2,sp=2 for
  gpt2, pp=2,dp=2 and pp=2,sp=2 for llama; virtual pp=2 too): losses and
  grad norms within atol=1e-5, rtol=1e-4, final params within 1e-4
  (`test_torch_sharded.py`'s bounds);
- with sp the port's ring (K1-K3 on chunk pairs inside every stage) is
  held against JAX's run with dense attention on the same mesh: the JAX
  package's ring and Ulysses open a shard_map that fails nested inside
  its pipeline's, so dense is the configuration of the same math JAX runs
  there. Each rank ran the kernels' plain versions once a live chunk pair
  a tick and layer: (M + F - 1) x L/F x (sp rank + 1) of K1 in the
  forward, and of K1, K2 and K3 in a training step (no remat);
- the virtual stages bit-equal to two gloo ranks in f32: loss and every
  gradient of one `grad_fn`;
- `pipeline_apply` of the reference MLP stages and its gradients against
  JAX's and against the stages run in order;
- the two microbatch ValueErrors, the F == 1 path, `n_layer % pp`; the
  "pipeline.ppermute" bytes equal to JAX's formula and to its accounting;
- the pp=2 `TrainState` saved by both ranks restored bit-equal at world 1
  and on four ranks' pp=2,dp=2 mesh in the port, and by JAX's
  `restore_state_sharded` on one device and on JAX's pp=2,dp=2 pipeline
  program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
import test_torch_sharded as S
from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu.models import moe as JMoE
from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel import pipeline as JP
from ray_tpu.train import checkpoint as JC
from ray_tpu.train import spmd as JS
from ray_tpu_torch.parallel import pipeline as PP
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.train import spmd as PS
from ray_tpu_torch.util.collective import hierarchy as H

TOL_FWD = dict(atol=2e-4, rtol=2e-4)
STEPS = 5
M = W.PIPE_M
# a run is (name, mesh config) or (name, mesh config, the port's attn_impl)
FWD_FOUR = [("gpt2", {"pp": 2, "tp": 2}), ("gpt2", {"pp": 2, "dp": 2}),
            ("gpt2", {"pp": 2, "fsdp": 2}), ("llama", {"pp": 2, "dp": 2}),
            ("gpt2", {"pp": 2, "ep": 2}), ("gpt2", {"pp": 2, "sp": 2}),
            ("llama", {"pp": 2, "sp": 2}),
            ("gpt2", {"pp": 2, "sp": 2}, "ulysses")]
TRAJ_FOUR = [("gpt2", {"pp": 2, "dp": 2}), ("gpt2", {"pp": 2, "tp": 2}),
             ("llama", {"pp": 2, "dp": 2}), ("gpt2", {"pp": 2, "fsdp": 2}),
             ("gpt2", {"pp": 2, "ep": 2}), ("gpt2", {"pp": 2, "sp": 2}),
             ("llama", {"pp": 2, "sp": 2})]
TRAJ_TWO = [("gpt2", {"pp": 2})]


def _tokens():
    return np.random.default_rng(10).integers(0, 512, (8, 17))


def _cfg(name, config=None):
    """JAX's config; on a mesh with sp, dense attention (its ring and
    Ulysses fail inside the pipeline's shard_map)."""
    kw = {"attn_impl": "dense"} if (config or {}).get("sp", 1) > 1 else {}
    if name == "gpt2":
        return JG, JG.GPT2Config.preset("gpt2-tiny", remat=False,
                                        dtype=jnp.float32, n_layer=4, **kw)
    return JL, JL.LlamaConfig.preset("llama-tiny", remat=False,
                                     dtype=jnp.float32, **kw)


def _mesh(config):
    n = int(np.prod(list(config.values())))
    return JM.build_mesh(JM.MeshConfig(**config), devices=jax.devices()[:n])


def _key(kind, name, config, impl="auto"):
    return W.pipe_key(kind, name, config, impl)


def _run_id(run):
    name, config, impl = W.pipe_run(run)
    return S.run_id(name, config) + ("" if impl == "auto" else f"-{impl}")


def _jax_weights(name):
    jmod, cfg = _cfg(name)
    return S._flat(jmod.init_params(jax.random.key(0), cfg))


def _jax_logits(name, config, tokens):
    """JAX's pipelined forward on build_mesh(config)."""
    jmod, cfg = _cfg(name, config)
    params = jmod.init_params(jax.random.key(0), cfg)
    mesh = _mesh(config)
    F = config["pp"]
    with JM.use_mesh(mesh):
        def fwd(params, toks):
            x = jmod.embed(params, toks, cfg)
            stage_fn = JP.make_stage_fn(
                lambda x, bp: jmod._block(x, bp, cfg), remat=False)
            x = JP.pipeline_apply(stage_fn, JP.stack_stages(
                params["blocks"], F), x, n_microbatches=M, mesh=mesh)
            return jmod.unembed(params, x, cfg)

        return np.asarray(jax.jit(fwd)(params, jnp.asarray(tokens,
                                                           jnp.int32)))


def _jax_trajectory(name, config):
    """JAX's compile_pipeline_train on build_mesh(config): (init weights,
    [(loss, grad_norm, step)], final weights, the program, its state)."""
    jmod, cfg = _cfg(name, config)
    train = JS.compile_pipeline_train(
        jmod, cfg, _mesh(config), n_microbatches=M,
        optimizer=JS.default_optimizer(**S.OPT))
    state = train.init_fn(jax.random.key(0))
    w0 = S._flat(state.params)
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": jnp.asarray(
            _tokens(), jnp.int32)})
        hist.append((float(m["loss"]), float(m["grad_norm"]),
                     int(m["step"])))
    return w0, hist, S._flat(state.params), train


@pytest.fixture(scope="module")
def jax_runs():
    return {_key("traj", n, c): _jax_trajectory(n, c)
            for n, c, _ in map(W.pipe_run, TRAJ_FOUR + TRAJ_TWO)}


def _spawn(tmp_path_factory, world, fwd, traj, restore=None):
    tmp = tmp_path_factory.mktemp(f"pipe{world}")
    names = {r[0] for r in fwd + traj}
    np.savez(tmp / "inputs.npz", tokens=_tokens(),
             **{f"w/{n}/{k}": v for n in names
                for k, v in _jax_weights(n).items()})
    return tmp, W.run_ranks(W.pipeline_ranks, world, str(tmp), fwd, traj,
                            STEPS, restore, timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory, two):
    # the four ranks also restore the two ranks' pp=2 checkpoint onto
    # their pp=2,dp=2 program
    return _spawn(tmp_path_factory, 4, FWD_FOUR, TRAJ_FOUR,
                  str(two[0] / "port-pp"))[1]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory, 2, [], TRAJ_TWO)


def _port_params(name):
    mod, cfg = W.pipe_family(name)
    return mod, cfg, mod.params_from_numpy(_jax_weights(name), cfg, "cpu")


def _check_trajectory(hist, end, jax_run):
    _, jhist, jend, _ = jax_run
    assert len(hist) == STEPS
    for (gl, gn, gs), (wl, wn, ws) in zip(hist, jhist):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, **S.TOL)
        np.testing.assert_allclose(gn, wn, **S.TOL)
    assert hist[-1][0] < hist[0][0]
    assert set(end) == set(jend)
    for key, arr in end.items():
        np.testing.assert_allclose(arr, jend[key], err_msg=key,
                                   **S.TOL_PARAMS)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("F", [2, 4])
def test_virtual_forward_matches_jax_and_sequential(F):
    mod, cfg, params = _port_params("gpt2")
    tokens = torch.from_numpy(_tokens()[:, :-1])
    got = W.pipe_logits(mod, cfg, params, tokens, F)
    want = _jax_logits("gpt2", {"pp": F}, _tokens()[:, :-1])
    np.testing.assert_allclose(got.numpy(), want, **TOL_FWD)
    with torch.no_grad():
        seq = mod.forward(params, tokens, cfg)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL_FWD)


def _ring_calls(rank, name, config, kernels):
    """The plain kernels' calls a ring run makes on `rank`: one a live chunk
    pair (sp rank + 1 of them) a tick and a layer of its stage."""
    dims = [a for a in JM.MESH_AXES if config.get(a, 1) > 1]
    sp_rank = (rank // int(np.prod([config[a] for a in
                                    dims[dims.index("sp") + 1:]]))
               ) % config["sp"]
    F = config["pp"]
    n = (M + F - 1) * W.pipe_family(name)[1].n_layer // F * (sp_rank + 1)
    return {k: n for k in kernels}


@pytest.mark.parametrize("run", FWD_FOUR, ids=_run_id)
def test_ranks_forward_matches_jax(four, run):
    name, config, impl = W.pipe_run(run)
    want = _jax_logits(name, config, _tokens()[:, :-1])
    mod, cfg, params = _port_params(name)
    with torch.no_grad():
        seq = mod.forward(params, torch.from_numpy(_tokens()[:, :-1]), cfg)
    x_bytes = _tokens()[:, :-1].size * cfg.d_model * 4
    F = config["pp"]
    for rank, o in enumerate(four):
        got, nbytes, calls = o[_key("fwd", name, config, impl)]
        np.testing.assert_allclose(got.numpy(), want, **TOL_FWD)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL_FWD)
        # JAX's count, of the whole activation: with dp or sp each pp
        # group's hops carry its shard, and the groups' shards make it up
        assert nbytes[("pipeline.ppermute", "float32", "intra")] == \
            (M + F - 1) * F * (x_bytes // M)
        if config.get("sp", 1) > 1 and impl == "auto":
            assert calls == _ring_calls(rank, name, config,
                                        ["flash_attention_reference"])


def test_mlp_stages_match_jax_and_run_in_order():
    F, d = 4, 8
    rng = np.random.default_rng(3)
    w = rng.standard_normal((F, d, d)).astype(np.float32) * 0.3
    b = rng.standard_normal((F, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((8, d)).astype(np.float32)
    mesh = _mesh({"pp": F})
    with JM.use_mesh(mesh):
        want = np.asarray(jax.jit(lambda p, x: JP.pipeline_apply(
            JP.mlp_stage_fn, p, x, n_microbatches=M, mesh=mesh))(
                {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    params = {"w": torch.from_numpy(w).requires_grad_(),
              "b": torch.from_numpy(b).requires_grad_()}
    xt = torch.from_numpy(x).requires_grad_()
    got = PP.pipeline_apply(PP.mlp_stage_fn, params, xt, n_microbatches=M)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL_FWD)
    seq = xt
    for s in range(F):
        seq = PP.mlp_stage_fn({"w": params["w"][s], "b": params["b"][s]},
                              seq)
    target = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    grads = [torch.autograd.grad(PP.mse_loss(y, target),
                                 [xt, params["w"], params["b"]])
             for y in (got, seq)]
    for g, w_ in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=1e-6,
                                   rtol=1e-5)
    init = PP.init_mlp_stage(torch.Generator().manual_seed(0), 3, 5,
                             device="cpu")
    assert init["w"].shape == (3, 5) and not init["b"].any()


# ----------------------------------------------------------- training

@pytest.mark.parametrize("run", TRAJ_FOUR, ids=_run_id)
def test_four_rank_trajectory_matches_jax(four, jax_runs, run):
    name, config, _ = W.pipe_run(run)
    hist, end, _ = four[0][_key("traj", name, config)]
    _check_trajectory(hist, end, jax_runs[_key("traj", name, config)])
    for rank, o in enumerate(four):
        got, _, calls = o[_key("traj", name, config)]
        assert got == hist
        if config.get("sp", 1) > 1:
            assert calls == _ring_calls(rank, name, config, [
                "flash_attention_reference", "_bwd_dq_reference",
                "_bwd_dkv_reference"])


def test_two_rank_trajectory_matches_jax(two, jax_runs):
    _, outs = two
    run = TRAJ_TWO[0]
    hist, end, _ = outs[0][_key("traj", *run)]
    _check_trajectory(hist, end, jax_runs[_key("traj", *run)])
    assert outs[1][_key("traj", *run)][0] == hist


def test_virtual_trajectory_matches_jax(jax_runs):
    opt = PS.default_optimizer(**S.OPT)
    mod, cfg, train = W.pipe_train("gpt2", MeshConfig(pp=2), opt)
    params = mod.params_from_numpy(_jax_weights("gpt2"), cfg, "cpu")
    state = PS.TrainState(0, params, opt.init(params))
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": _tokens()})
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    _check_trajectory(hist, mod.params_to_numpy(state.params),
                      jax_runs[_key("traj", "gpt2", {"pp": 2})])


def test_virtual_stages_bit_equal_to_gloo_ranks(two):
    # one thread, as the ranks run: a product's sums split over threads
    # round in another order
    _, outs = two
    opt = PS.default_optimizer(**S.OPT)
    mod, cfg, train = W.pipe_train("gpt2", MeshConfig(pp=2), opt)
    params = mod.params_from_numpy(_jax_weights("gpt2"), cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, grads = train.grad_fn(PS.TrainState(0, params, None),
                                    {"tokens": _tokens()})
    finally:
        torch.set_num_threads(threads)
    want = mod.params_to_numpy(grads)
    for o in outs:
        got_loss, got = o["grads"]
        assert got_loss == loss.item()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].tobytes() == v.tobytes(), k


# ---------------------------------------------------- contract, bytes

def test_microbatch_errors_and_single_stage_path():
    F, d = 2, 8
    params = {"w": torch.zeros(F, d, d), "b": torch.zeros(F, d)}
    x = torch.ones(8, d)
    with pytest.raises(ValueError, match="< pipeline depth"):
        PP.pipeline_apply(PP.mlp_stage_fn, params, x, n_microbatches=1)
    with pytest.raises(ValueError, match="not divisible"):
        PP.pipeline_apply(PP.mlp_stage_fn, params, x, n_microbatches=3)
    one = {"w": torch.randn(1, d, d), "b": torch.randn(1, d)}
    got = PP.pipeline_apply(PP.mlp_stage_fn, one, x, n_microbatches=3)
    assert torch.equal(got, PP.mlp_stage_fn({"w": one["w"][0],
                                             "b": one["b"][0]}, x))
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        PP.stack_stages({"w": torch.zeros(4, 2)}, 3)
    mod, cfg = W.pipe_family("gpt2")
    with pytest.raises(ValueError, match="n_layer=4 not divisible by pp=3"):
        PS.compile_pipeline_train(mod, cfg, MeshConfig(pp=3), M,
                                  device="cpu")
    with pytest.raises(ValueError, match="pp alone"):
        PS.compile_pipeline_train(mod, cfg, {"pp": 2, "dp": 2}, M,
                                  device="cpu")


def test_moe_pipeline_refused_as_jax_has_none():
    # the JAX pipeline names gpt2 and llama (its moe has no embed/unembed
    # and its blocks carry the router's aux loss)
    mod, cfg = W.family("moe")
    with pytest.raises(NotImplementedError, match="gpt2 and llama"):
        PS.compile_pipeline_train(mod, cfg, MeshConfig(pp=2), M,
                                  device="cpu")
    assert not hasattr(JMoE, "embed") and not hasattr(JMoE, "unembed")


@pytest.mark.parametrize("F,Mb", [(2, 4), (4, 4), (4, 8)])
def test_ppermute_bytes_equal_jax(F, Mb):
    x = np.ones((8, 4), np.float32)
    want = {}

    def spy(op, nbytes, dtype, hop="world"):
        want[(op, str(dtype), hop)] = int(nbytes)

    old, JP.account_collective = JP.account_collective, spy
    mesh = _mesh({"pp": F})
    try:
        with JM.use_mesh(mesh):
            JP.pipeline_apply(lambda p, xb: xb, jnp.zeros((F, 1)),
                              jnp.asarray(x, jnp.bfloat16),
                              n_microbatches=Mb, mesh=mesh)
    finally:
        JP.account_collective = old
    H.BYTES.clear()
    PP.pipeline_apply(lambda p, xb: xb, torch.zeros(F, 1),
                      torch.from_numpy(x).to(torch.bfloat16),
                      n_microbatches=Mb)
    assert dict(H.BYTES) == want
    assert want == {("pipeline.ppermute", "bfloat16", "intra"):
                    (Mb + F - 1) * F * (x.size * 2 // Mb)}


# ---------------------------------------------------------- checkpoints

def test_pp_state_restores_at_world_one_and_in_jax(two, four, jax_runs):
    tmp, outs = two
    want = outs[0]["saved"]
    assert outs[1]["saved"].keys() == want.keys()
    for o in four:                      # on pp=2,dp=2
        _check_bits(o["restored"], want)
    path = str(tmp / "port-pp")
    manifest = JC.read_sharded_manifest(path)
    assert (manifest["world_size"], manifest["num_save_processes"]) == (2, 2)
    mod, cfg = W.pipe_family("gpt2")
    one = PS.compile_model_train(mod, cfg, optimizer=PS.default_optimizer(
        **S.OPT), device="cpu")
    got = PS.restore_state_sharded(path, one)
    assert got.step == STEPS
    _check_bits(W.state_numpy(got), want)
    jmod, jcfg = _cfg("gpt2")
    progs = [JS.compile_model_train(jmod, jcfg, _mesh({"dp": 1}),
                                    optimizer=JS.default_optimizer(**S.OPT)),
             jax_runs[_key("traj", "gpt2", {"pp": 2, "dp": 2})][3]]
    for prog in progs:
        got = JS.restore_state_sharded(path, prog)
        assert int(got.step) == STEPS
        _check_bits({JC._leaf_key(kp): np.asarray(leaf) for kp, leaf in
                     jax.tree_util.tree_flatten_with_path(
                         JS._state_as_tree(got))[0]}, want)


def _check_bits(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, arr in want.items():
        g = np.asarray(got[key])
        assert g.shape == arr.shape and g.dtype == arr.dtype, key
        assert g.tobytes() == arr.tobytes(), key
