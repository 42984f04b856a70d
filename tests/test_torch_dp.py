"""The port's data-parallel training against one device and the JAX package.

Ranks are spawned processes on gloo (`_torch_dist_workers`), meeting
through FileStores under tmp_path; weights are the JAX package's gpt2-tiny
init (f32), carried across as the numpy leaves of `params_from_numpy`;
batches are numpy, from a seed.

- `Topology(2, 1)`: the 4-step trajectory at a global batch of 4 equals one
  device's at the same batch within atol=1e-5, rtol=1e-4
  (`test_torch_train.py`'s f32 gradient bound: the two ranks' halves are
  summed in another order); both ranks hold the same bits;
- `Topology(2, 2)`: the fused trajectory against JAX's `compile_train` on
  `build_hierarchical_mesh(topology=Topology(2, 2))`, same bounds;
- the JAX package's `test_fused_ef_int8_trains_close_to_fp32`: its
  quadratic, 100 SGD steps at `Topology(2, 2)`, int8 chunk 64 with error
  feedback, the same bars (f32 loss < 1e-3, int8-EF loss < 5e-2);
- `sync_fn` is the fused step's sync; `timed_step_fn` gives the fused
  step's bits with five phases timed; the `ValueError`s JAX raises.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
from ray_tpu.models import gpt2 as J
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu.util.collective import hierarchy as JH
from ray_tpu_torch.models import gpt2 as P
from ray_tpu_torch.parallel import mesh as PM
from ray_tpu_torch.train import spmd as PS
from ray_tpu_torch.util.collective.hierarchy import Topology
from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

TOL = dict(atol=1e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup=2, total_steps=20)
STEPS = 4


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's fused step on a 2 x 2 hierarchical mesh of 4 virtual devices:
    (init weights, [(loss, grad_norm, step)], final weights, tokens)."""
    cfg = J.GPT2Config.preset("gpt2-tiny", dtype=jax.numpy.float32)
    mesh = JM.build_hierarchical_mesh({"dp": 4}, devices=jax.devices()[:4],
                                      topology=JH.Topology(2, 2))
    train = JS.compile_gpt2_train(cfg, mesh,
                                  optimizer=JS.default_optimizer(**OPT))
    state = train.init_fn(jax.random.key(0))
    w0 = _flat(state.params)
    tokens = np.random.default_rng(9).integers(0, 512, (4, 33)).astype(
        np.int32)
    hist = []
    for _ in range(STEPS):
        state, m = train.step_fn(state, {"tokens": jax.numpy.asarray(tokens)})
        hist.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    return w0, hist, _flat(state.params), tokens


def _write_inputs(tmp, jax_run):
    w0, _, _, tokens = jax_run
    rng = np.random.RandomState(0)
    xb = rng.randn(4, 8).astype(np.float32)
    w_true = rng.randn(8).astype(np.float32)
    quad = np.concatenate([xb, (xb @ w_true)[:, None]], axis=1)
    np.savez(tmp / "inputs.npz", tokens=tokens, quad=quad,
             **{f"w/{k}": v for k, v in w0.items()})


@pytest.fixture(scope="module")
def dp2(tmp_path_factory, jax_run):
    tmp = tmp_path_factory.mktemp("dp2")
    _write_inputs(tmp, jax_run)
    return W.run_ranks(W.dp_two_ranks, 2, str(tmp))


@pytest.fixture(scope="module")
def dp4(tmp_path_factory, jax_run):
    tmp = tmp_path_factory.mktemp("dp4")
    _write_inputs(tmp, jax_run)
    return W.run_ranks(W.dp_four_ranks, 4, str(tmp))


def _one_device(w0, tokens, steps=STEPS):
    cfg = P.GPT2Config.preset("gpt2-tiny", dtype=torch.float32)
    opt = PS.default_optimizer(**OPT)
    train = PS.compile_gpt2_train(cfg, optimizer=opt, device="cpu")
    params = P.params_from_numpy(w0, cfg, device="cpu")
    state = PS.TrainState(0, params, opt.init(params))
    hist = []
    for _ in range(steps):
        state, m = train.step_fn(state, {"tokens": tokens})
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return hist, P.params_to_numpy(state.params)


def _same_trajectory(got, want):
    (ghist, gparams), (whist, wparams) = got, want
    for (gl, gn, gs), (wl, wn, ws) in zip(ghist, whist):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, **TOL)
        np.testing.assert_allclose(gn, wn, **TOL)
    assert ghist[-1][0] < ghist[0][0]
    for key, arr in gparams.items():
        np.testing.assert_allclose(arr, wparams[key], err_msg=key, **TOL)


def test_two_rank_trajectory_equals_one_device(dp2, jax_run):
    w0, _, _, tokens = jax_run
    want = _one_device(w0, tokens)
    for o in dp2:
        _same_trajectory((o["hist"], o["params"]), want)


def test_ranks_hold_the_same_bits(dp2, dp4):
    for outs in (dp2, dp4):
        for o in outs[1:]:
            assert o["hist"] == outs[0]["hist"]
            for key, arr in o["params"].items():
                assert arr.tobytes() == outs[0]["params"][key].tobytes()


def test_fused_2x2_trajectory_matches_jax(dp4, jax_run):
    _, hist, w_end, _ = jax_run
    _same_trajectory((dp4[0]["hist"], dp4[0]["params"]), (hist, w_end))


def test_sync_fn_is_the_fused_steps_sync(dp2):
    for o in dp2:
        loss_s, g_s, loss_g, g_g, g_own = o["sync"]
        assert loss_s == loss_g
        for key, arr in g_s.items():
            assert arr.tobytes() == g_g[key].tobytes() == \
                g_own[key].tobytes(), key


def test_timed_step_gives_the_fused_steps_bits(dp2):
    for o in dp2:
        (fused, f_loss, _), (timed, t_loss, phases) = o["timed"]
        assert t_loss == pytest.approx(f_loss, rel=1e-6)
        for key, arr in fused.items():
            assert arr.tobytes() == timed[key].tobytes(), key
        assert set(phases) == {"compute", "rs", "ar", "ag", "apply"}
        assert all(v >= 0.0 for v in phases.values())


def test_fused_ef_int8_trains_close_to_fp32(dp4):
    for o in dp4:
        losses_fp, w_fp, _ = o["quad_f32"]
        losses_q, w_q, ef_shape = o["quad_int8_ef"]
        assert losses_fp[-1] < 1e-3, f"fp32 baseline failed to fit: " \
            f"{losses_fp[-1]}"
        assert losses_q[-1] < 5e-2, f"EF int8 diverged from fp32 " \
            f"({losses_q[-1]} vs {losses_fp[-1]})"
        # 8 grads over intra 2: a shard of 4 padded to one chunk of 64
        assert ef_shape == (64,)
        assert torch.equal(w_q, dp4[0]["quad_int8_ef"][1])


# ----------------------------------------------- one rank, in this process
@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "default"), 1), rank=0, world_size=1)
    try:
        yield PM.build_hierarchical_mesh(topology=Topology(1, 1),
                                         device_type="cpu")
    finally:
        dist.destroy_process_group()


def _linear_train(mesh, **kw):
    return PS.compile_train(
        lambda p, b: torch.mean(b["x"] @ p["w"]),
        lambda g, device: {"w": torch.zeros(8, device=device)},
        mesh=mesh, device="cpu", **kw)


def test_world_one_step_bit_equal_to_one_device(world1, jax_run):
    w0, _, _, tokens = jax_run
    cfg = P.GPT2Config.preset("gpt2-tiny", dtype=torch.float32)
    runs = []
    for mesh in (None, world1):
        opt = PS.default_optimizer(**OPT)
        train = PS.compile_gpt2_train(cfg, mesh=mesh, optimizer=opt,
                                      device="cpu")
        params = P.params_from_numpy(w0, cfg, device="cpu")
        state = PS.TrainState(0, params, opt.init(params))
        losses = []
        for _ in range(3):
            state, m = train.step_fn(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
        runs.append((losses, P.params_to_numpy(state.params)))
    assert runs[0][0] == runs[1][0]
    for key, arr in runs[0][1].items():
        assert arr.tobytes() == runs[1][1][key].tobytes(), key
    assert PS.compile_gpt2_train(cfg, mesh=world1, device="cpu") \
        .topology == Topology(1, 1, "dp_inter", "dp_intra")


def test_value_errors_as_jax_raises(world1):
    q = QuantizedAllreduce(dtype="int8", chunk=64)
    with pytest.raises(ValueError, match="hierarchical"):
        _linear_train(None, grad_quantize=q)
    with pytest.raises(ValueError, match="hierarchical"):
        _linear_train(None, phase_timing=True)
    with pytest.raises(ValueError, match="error-feedback"):
        _linear_train(world1, grad_quantize=q, phase_timing=True)
    train = _linear_train(world1, grad_quantize=q)
    with pytest.raises(RuntimeError, match="init_fn"):
        train.init_ef_fn()
    state = train.init_fn(torch.Generator())
    assert train.init_ef_fn().shape == (64,)
    with pytest.raises(TypeError, match="ef"):
        train.step_fn(state, {"x": np.ones((2, 8), np.float32)})
    from torch.distributed.device_mesh import DeviceMesh

    flat = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("dp",))
    with pytest.raises(ValueError, match="params_spec"):
        _linear_train(flat)
    train = _linear_train(flat, params_spec={"w": PM.P()})
    state, m = train.step_fn(train.init_fn(torch.Generator()),
                             {"x": np.ones((2, 8), np.float32)})
    assert float(m["loss"]) == 0.0 and state.step == 1
    # sp trains on a build_mesh mesh (ring attention); pp is refused
    pipe = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("pp",))
    with pytest.raises(NotImplementedError, match="compile_pipeline_train"):
        _linear_train(pipe, params_spec={"w": PM.P()})


def test_batch_rows_split_evenly():
    rows = PS._rank_rows({"x": np.arange(8).reshape(4, 2)}, 1, 2)
    assert rows["x"].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="split evenly"):
        PS._rank_rows({"x": np.zeros((3, 2))}, 0, 2)


def test_build_hierarchical_mesh_refusals(world1):
    # pp is refused on it, as the JAX package's pipeline fails there
    with pytest.raises(NotImplementedError, match="pp on a hierarchical"):
        PM.build_hierarchical_mesh({"dp": 1, "pp": 2}, device_type="cpu")
    with pytest.raises(ValueError, match="topology"):
        PM.build_hierarchical_mesh(topology=Topology(2, 1),
                                   device_type="cpu")
    mesh = PM.build_hierarchical_mesh(device_type="cpu")  # hosts of ranks
    assert PM.hier_topology(mesh) == Topology(1, 1, "dp_inter", "dp_intra")
    assert PM.dp_axis_names(mesh) == PM.DP_SUB_AXES
    assert PM.is_hierarchical_mesh(mesh) and not PM.is_hierarchical_mesh(None)
    with pytest.raises(ValueError, match="dp_inter"):
        PM.hier_topology(object())


def test_build_hierarchical_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        PM.build_hierarchical_mesh(topology=Topology(1, 1),
                                   device_type="cpu")
