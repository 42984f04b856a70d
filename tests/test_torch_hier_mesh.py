"""The hierarchical mesh composed with fsdp, sp, ep and tp in the port
(`parallel/mesh.build_hierarchical_mesh`, `train/spmd.compile_model_train`)
against the JAX package's `compile_model_train` on its
`build_hierarchical_mesh` over the same virtual CPU devices.

The JAX step is manual over the (dp_inter, dp_intra) pair only and leaves
the other axes to its partitioner; the port places params and rows on the
mesh's other axes with DTensor and runs the two-level sync over the dp
pair on each rank's local gradient shards. Ranks are spawned gloo
interpreters (`_torch_dist_workers.hier_ranks`), every run from the JAX
package's init (f32) carried as numpy, 5 steps on a seeded 8 x 33 token
batch:

- Topology(2, 2) x tp=2 on 8 ranks (gpt2-tiny), and Topology(2, 1) x tp=2
  on 4 (here); x fsdp=2, x ep=2, x sp=2 and llama-tiny x tp=2 on 4 ranks
  in `test_torch_hier_mesh_axes.py` (sp with the port's ring against
  JAX's dense attention: the JAX ring's shard_map fails nested inside the
  fused sync's);
- losses and grad norms within atol=1e-5, rtol=1e-4, final params within
  1e-4 (`test_torch_sharded.py`'s bounds), every rank's losses the same;
  the ring's plain kernels once a live chunk pair of the rank's sp
  coordinate in step 2 (K1 twice a layer: forward and remat recompute);
- the int8 inter hop with error feedback on Topology(2, 1) x tp=2 against
  JAX's int8 run with error feedback, at the same bounds;
- the timed step (`phase_timing`) bit-equal to the fused one on the
  composed mesh, its five phases timed;
- the refusals: pp on the hierarchical mesh (where JAX's pipeline fails)
  and `compile_pipeline_train` on one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
import test_torch_sharded as S
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu.util.collective.hierarchy import Topology as JTopology
from ray_tpu.util.collective.quantize import \
    QuantizedAllreduce as JQuantizedAllreduce
from ray_tpu_torch.parallel import mesh as PM
from ray_tpu_torch.train import spmd as PS
from ray_tpu_torch.util.collective.hierarchy import Topology

STEPS = 5
# (name, config, (inter, intra)[, the port's attn_impl[, quantize]])
EIGHT = [("gpt2", {"dp": 4, "tp": 2}, (2, 2))]
FOUR = [("gpt2", {"dp": 2, "tp": 2}, (2, 1)),
        ("gpt2", {"dp": 2, "tp": 2}, (2, 1), "auto", "int8_ef")]


def _tokens():
    return np.random.default_rng(11).integers(0, 512, (8, 33)).astype(
        np.int64)


def run_parts(run):
    name, config, topo, *rest = run
    rest += ["auto", None][len(rest):]
    return name, config, topo, rest[0], rest[1]


def run_id(run):
    name, config, topo, impl, quantize = run_parts(run)
    return "-".join([S.run_id(name, config), f"topo{topo[0]}x{topo[1]}"]
                    + ([quantize] if quantize else []))


def jax_run(run):
    """JAX's compile_model_train on its hierarchical mesh: (init weights,
    [(loss, grad_norm, step)], final weights)."""
    name, config, topo, _, quantize = run_parts(run)
    jmod, cls, preset = S.JAX_FAMILIES[name]
    kw = {"attn_impl": "dense"} if config.get("sp", 1) > 1 else {}
    cfg = getattr(jmod, cls).preset(preset, dtype=jnp.float32, **kw)
    n = int(np.prod(list(config.values())))
    mesh = JM.build_hierarchical_mesh(config, devices=jax.devices()[:n],
                                      topology=JTopology(*topo))
    opt = JS.default_optimizer(**S.OPT)
    if quantize is None:
        train = JS.compile_model_train(jmod, cfg, mesh, optimizer=opt)
    else:
        with JM.use_mesh(mesh):
            spec = jmod.param_specs(cfg)
        train = JS.compile_train(
            loss_fn=lambda p, b: jmod.loss_fn(p, b, cfg),
            init_params_fn=lambda k: jmod.init_params(k, cfg),
            params_spec=spec, mesh=mesh, optimizer=opt,
            grad_quantize=JQuantizedAllreduce(dtype="int8", chunk=64,
                                              error_feedback=True))
    state = train.init_fn(jax.random.key(0))
    w0 = S._flat(state.params)
    ef = train.init_ef_fn() if train.init_ef_fn is not None else None
    hist = []
    for _ in range(STEPS):
        batch = {"tokens": jnp.asarray(_tokens(), jnp.int32)}
        if ef is None:
            state, m = train.step_fn(state, batch)
        else:
            state, m, ef = train.step_fn(state, batch, ef)
        hist.append((float(m["loss"]), float(m["grad_norm"]),
                     int(m["step"])))
    return w0, hist, S._flat(state.params)


@pytest.fixture(scope="module")
def jax_runs():
    return {W.hier_key(*run_parts(r)): jax_run(r) for r in EIGHT + FOUR}


def ranks(tmp_path_factory, jax_runs, runs, world):
    """`W.hier_ranks` of `runs` on `world` spawned gloo ranks, from the JAX
    runs' init weights."""
    tmp = tmp_path_factory.mktemp(f"hier{world}")
    weights = {f"w/{r[0]}/{k}": v for r in runs
               for k, v in jax_runs[W.hier_key(*run_parts(r))][0].items()}
    np.savez(tmp / "inputs.npz", tokens=_tokens(), **weights)
    return W.run_ranks(W.hier_ranks, world, str(tmp),
                       [run_parts(r) for r in runs], STEPS, timeout=240)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, jax_runs):
    return ranks(tmp_path_factory, jax_runs, EIGHT, 8)


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_runs):
    return ranks(tmp_path_factory, jax_runs, FOUR, 4)


def check(outs, jax_runs, run):
    """Rank 0's trajectory against JAX's, every rank's the same, and on sp
    the ring's plain kernels once a live chunk pair."""
    name, config = run[:2]
    key = W.hier_key(*run_parts(run))
    _, jhist, jend = jax_runs[key]
    hist, params, _ = outs[0][key]
    assert len(hist) == STEPS
    for (gl, gn, gs), (wl, wn, ws) in zip(hist, jhist):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, **S.TOL)
        np.testing.assert_allclose(gn, wn, **S.TOL)
    assert hist[-1][0] < hist[0][0]
    assert set(params) == set(jend)
    for k, arr in params.items():
        np.testing.assert_allclose(arr, jend[k], err_msg=k, **S.TOL_PARAMS)
    n_layer = W.family(name)[1].n_layer
    dims = [a for a in PM.HIER_MESH_AXES if a not in PM.DP_SUB_AXES
            and config.get(a, 1) > 1]
    for rank, o in enumerate(outs):
        assert o[key][0] == hist
        if config.get("sp", 1) == 1:
            continue
        # ranks are row-major (dp_inter, dp_intra, fsdp, sp, ep, tp)
        sp_rank = (rank // int(np.prod([config[a] for a in
                                        dims[dims.index("sp") + 1:]]))
                   ) % config["sp"]
        live = sp_rank + 1
        assert o[key][2] == {"flash_attention_reference": 2 * n_layer * live,
                             "_bwd_dq_reference": n_layer * live,
                             "_bwd_dkv_reference": n_layer * live}


@pytest.mark.parametrize("run", EIGHT, ids=run_id)
def test_eight_rank_trajectory_matches_jax(eight, jax_runs, run):
    check(eight, jax_runs, run)


@pytest.mark.parametrize("run", FOUR, ids=run_id)
def test_four_rank_trajectory_matches_jax(four, jax_runs, run):
    check(four, jax_runs, run)


@pytest.mark.parametrize("world", [8, 4])
def test_timed_step_equals_fused_step(eight, four, world):
    check_timed(eight if world == 8 else four)


def check_timed(outs):
    """Every rank's timed step (`phase_timing`) bit-equal to its fused
    step from the same weights, its five phases timed."""
    for o in outs:
        (fused, loss, _), (timed, t_loss, phases) = o["timed"]
        assert loss == t_loss
        assert set(fused) == set(timed)
        for k, arr in fused.items():
            assert arr.tobytes() == timed[k].tobytes(), k
        assert set(phases) == {"compute", "rs", "ar", "ag", "apply"}


# ----------------------------------------------------------- one rank
@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "default"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_composed_mesh_layout_and_refusals(world1):
    mesh = PM.build_hierarchical_mesh({"dp": 1, "tp": 1, "sp": 1},
                                      topology=Topology(1, 1),
                                      device_type="cpu")
    assert PM.mesh_axes(mesh) == PM.DP_SUB_AXES   # dp alone: the 2-D mesh
    assert PM.model_submesh(mesh) is None
    mesh = PM.full_hierarchical_mesh(topology=Topology(1, 1),
                                     device_type="cpu")
    assert PM.mesh_axes(mesh) == PM.HIER_MESH_AXES
    assert PM.mesh_axes(PM.model_submesh(mesh)) == ("tp",)
    assert PM.hier_topology(mesh) == Topology(1, 1, "dp_inter", "dp_intra")
    with pytest.raises(NotImplementedError, match="context mesh"):
        PM.build_hierarchical_mesh({"dp": 1, "pp": 2}, device_type="cpu")
    mod, cfg = W.pipe_family("gpt2")
    with pytest.raises(NotImplementedError, match="queue 3"):
        PS.compile_pipeline_train(mod, cfg, mesh, 4, device="cpu")
    with pytest.raises(ValueError, match="params_spec"):
        PS.compile_train(lambda p, b: p["w"].sum(),
                         lambda g, device: {"w": torch.zeros(2)},
                         mesh=mesh, device="cpu")


def test_composed_world_one_step_bit_equal_to_one_device(world1):
    """The composed path at world 1 (every degree 1) against one device:
    the same losses and params, bit for bit."""
    mesh = PM.full_hierarchical_mesh(topology=Topology(1, 1),
                                     device_type="cpu")
    mod, cfg = W.family("gpt2")
    tokens = _tokens()[:4]
    runs = []
    for m in (None, mesh):
        opt = PS.default_optimizer(**S.OPT)
        train = PS.compile_model_train(mod, cfg, mesh=m, optimizer=opt,
                                       device="cpu")
        state = train.init_fn(torch.Generator().manual_seed(0))
        losses = []
        for _ in range(3):
            state, met = train.step_fn(state, {"tokens": tokens})
            losses.append(float(met["loss"]))
        runs.append((losses, mod.params_to_numpy(PS.unshard(state.params))))
    assert runs[0][0] == runs[1][0]
    for k, arr in runs[0][1].items():
        assert arr.tobytes() == runs[1][1][k].tobytes(), k
