"""The port's mesh configuration and logical-axis rules against the JAX
package's (`ray_tpu/parallel/mesh.py`), and `train.spmd.state_shardings`.

Pure Python, one process: `MeshConfig.resolved` and `adaptive_mesh_config`
over a grid of requests (errors included), `logical_to_spec` and each
family's `param_logical_axes`/`param_specs` leaf for leaf under the
default rules, an override and a hierarchical mesh's rules, the placements
a spec gives on a mesh, and the meshes `build_mesh` makes at world 1.
"""

import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu.models import moe as JMoE
from ray_tpu.parallel import mesh as JM
from ray_tpu.util.collective.hierarchy import Topology as JTopology
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.models import llama as PL
from ray_tpu_torch.models import moe as PMoE
from ray_tpu_torch.parallel import mesh as PM
from ray_tpu_torch.train import spmd as PS

FAMILIES = [(JG, PG, "GPT2Config", "gpt2-tiny"),
            (JL, PL, "LlamaConfig", "llama-tiny"),
            (JMoE, PMoE, "MoEConfig", "moe-tiny")]
OVERRIDE = {"embed": None, "mlp": ("tp", "fsdp"), "kv": "tp",
            "batch": "dp", "heads": ("fsdp", "tp")}

REQUESTS = [dict(dp=-1), dict(dp=2, tp=2), dict(fsdp=-1, tp=2),
            dict(dp=2, fsdp=-1), dict(pp=2, dp=-1, tp=2), dict(ep=4),
            dict(dp=-1, ep=-1), dict(tp=3), dict(dp=2, fsdp=2, tp=2),
            dict(sp=2, dp=-1), dict(dp=8, tp=2), dict(tp=2, pp=2, ep=2)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_mesh_config_resolved_as_jax(n):
    for req in REQUESTS:
        want = _outcome(lambda: JM.MeshConfig(**req).resolved(n).degrees())
        got = _outcome(lambda: PM.MeshConfig(**req).resolved(n).degrees())
        assert got == want, (req, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 12, 16])
def test_adaptive_mesh_config_as_jax(n):
    for req in REQUESTS + [dict(dp=4, fsdp=2), dict(dp=2, fsdp=4, tp=2)]:
        for shrink in (("dp", "fsdp"), ("fsdp",), ("dp",)):
            want = _outcome(lambda: JM.adaptive_mesh_config(
                req, n, shrink).degrees())
            got = _outcome(lambda: PM.adaptive_mesh_config(
                req, n, shrink).degrees())
            assert got == want, (req, n, shrink)


def _flat_axes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_flat(tree, is_leaf):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("jmod,pmod,cls,preset", FAMILIES)
def test_param_logical_axes_and_specs_as_jax(jmod, pmod, cls, preset):
    jcfg = getattr(jmod, cls).preset(preset)
    pcfg = getattr(pmod, cls).preset(preset)
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    want_axes = _jax_flat(jmod.param_logical_axes(jcfg), is_tuple)
    got_axes = _flat_axes(pmod.param_logical_axes(pcfg))
    assert got_axes == want_axes
    assert set(got_axes) == set(pmod.param_shapes(pcfg))
    hier = JM.build_hierarchical_mesh({"dp": 4}, devices=jax.devices()[:4],
                                      topology=JTopology(2, 2))
    phier = types.SimpleNamespace(mesh_dim_names=PM.DP_SUB_AXES)
    for jrules, prules in ((None, None), (OVERRIDE, OVERRIDE),
                           (JM.rules_for_mesh(hier, OVERRIDE),
                            PM.rules_for_mesh(phier, OVERRIDE))):
        assert prules == jrules
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
        want = _jax_flat(jmod.param_specs(jcfg, jrules), is_spec)
        got = _flat_axes(pmod.param_specs(pcfg, prules))
        assert set(got) == set(want)
        for key, spec in want.items():
            assert tuple(got[key]) == tuple(spec), (key, jrules)
            assert isinstance(got[key], PM.PartitionSpec)
        # the active rules, as compile_model_train reads them
        with JM.use_mesh(hier, jrules):
            want_active = _jax_flat(jmod.param_specs(jcfg), is_spec)
        with PM.use_mesh(None, prules):
            got_active = _flat_axes(pmod.param_specs(pcfg))
        assert {k: tuple(v) for k, v in got_active.items()} == \
            {k: tuple(v) for k, v in want_active.items()}


def test_logical_to_spec_as_jax():
    names = [None, "batch", "seq", "embed", "mlp", "heads", "kv", "vocab",
             "expert", "stage", "layers", "unknown"]
    rng = np.random.default_rng(0)
    for _ in range(200):
        axes = tuple(rng.choice(names, size=rng.integers(0, 5)))
        axes = tuple(None if a is None else str(a) for a in axes)
        for rules in (None, OVERRIDE):
            want = JM.logical_to_spec(*axes, rules=rules)
            got = PM.logical_to_spec(*axes, rules=rules)
            assert tuple(got) == tuple(want), (axes, rules)
    assert PM.DEFAULT_RULES == JM.DEFAULT_RULES
    assert PM.MESH_AXES == JM.MESH_AXES
    assert PM.HIER_MESH_AXES == JM.HIER_MESH_AXES


def test_spec_to_placements():
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "fsdp", "tp"))
    P = PM.P
    assert PM.spec_to_placements(mesh, P(("dp", "fsdp"), None, "tp")) == \
        (Shard(0), Shard(0), Shard(2))
    assert PM.spec_to_placements(mesh, P()) == (Replicate(),) * 3
    # axes of degree 1 are not in the mesh and resolve to nothing
    assert PM.spec_to_placements(mesh, P("ep", ("sp", "tp"))) == \
        (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        PM.spec_to_placements(mesh, P(("fsdp", "dp")))
    with pytest.raises(ValueError, match="twice"):
        PM.spec_to_placements(mesh, P("tp", "tp"))
    with pytest.raises(ValueError, match="unknown"):
        PM.spec_to_placements(mesh, P("model"))


def test_constrain_without_a_mesh_is_a_no_op():
    x = torch.randn(2, 3)
    assert PM.current_mesh() is None
    assert PM.constrain(x, "batch", "embed") is x
    mesh = types.SimpleNamespace(mesh_dim_names=("tp",))
    with PM.use_mesh(mesh):
        assert PM.current_mesh() is mesh
        assert PM.constrain(x, "batch", "embed") is x    # a plain tensor
        with PM.suppress_constraints():
            assert PM.constrain(x, "vocab") is x
    assert PM.current_mesh() is None


@pytest.mark.parametrize("pmod,cls,preset",
                         [(PG, "GPT2Config", "gpt2-tiny"),
                          (PMoE, "MoEConfig", "moe-tiny")])
def test_state_shardings_mirror_the_moments(pmod, cls, preset):
    cfg = getattr(pmod, cls).preset(preset)
    mesh = types.SimpleNamespace(mesh_dim_names=("fsdp", "ep", "tp"),
                                 ndim=3)
    specs = pmod.param_specs(cfg)
    opt = PS.default_optimizer()
    meta = PS._tree_map(lambda _: torch.empty(0, device="meta"), specs)
    state = PS.TrainState(0, meta, opt.init(meta))
    sh = PS.state_shardings(state, specs, mesh)
    want = PS._leaves(PS._tree_map(
        lambda s: PM.spec_to_placements(mesh, s), specs))
    got = [s.placements for s in PS._leaves(sh.params)]
    assert got == want
    assert any(isinstance(p, Shard) for pl in got for p in pl)
    for moments in (sh.opt_state.mu, sh.opt_state.nu):
        assert [s.placements for s in PS._leaves(moments)] == want
    rep = (Replicate(),) * 3
    assert sh.step.placements == rep
    assert sh.opt_state.count.placements == rep
    assert all(s.mesh is mesh for s in PS._leaves(sh.params))


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "default"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_build_mesh_names_only_axes_above_one(world1):
    mesh = PM.build_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
    mesh = PM.build_mesh(PM.MeshConfig(), device_type="cpu")
    assert mesh.mesh_dim_names == ("dp",)
    assert PM.axis_size(mesh, "sp", "tp") == 1
    assert PM.dp_axis_names(mesh) == ("dp",)
    with pytest.raises(ValueError, match="slots"):
        PM.build_mesh({"tp": 2}, device_type="cpu")
    assert PM.local_window((5, 3), mesh, (Shard(0),)) == \
        (slice(0, 5), slice(0, 3))
    topo = PM.topology_from_devices()
    assert (topo.inter, topo.intra) == (1, 1)


def test_build_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        PM.build_mesh(device_type="cpu")


def test_world_one_mesh_step_bit_equal_to_one_device(world1):
    # every axis at 1: params, moments and batch are DTensors on a mesh of
    # one rank, and each op runs on the same local tensor as on one device
    cfg = PG.GPT2Config.preset("gpt2-tiny", dtype=torch.float32,
                               attn_impl="flash", remat_policy="dots",
                               ce_chunk=16)
    tokens = np.random.default_rng(9).integers(0, 512, (2, 33))
    runs = []
    for mesh in (None, PM.build_mesh(PM.MeshConfig(), device_type="cpu")):
        opt = PS.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
        train = PS.compile_gpt2_train(cfg, mesh=mesh, optimizer=opt,
                                      device="cpu")
        state = train.init_fn(torch.Generator().manual_seed(0))
        hist = []
        for _ in range(3):
            state, m = train.step_fn(state, {"tokens": tokens})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((hist, PG.params_to_numpy(PS.unshard(state.params))))
    assert runs[0][0] == runs[1][0]
    for key, arr in runs[0][1].items():
        assert arr.tobytes() == runs[1][1][key].tobytes(), key


def test_with_current_mesh_carries_the_mesh_to_another_thread():
    # the autograd engine recomputes a checkpointed block of CUDA tensors
    # on its own thread; the block's constrain calls must see the mesh
    import threading

    mesh = types.SimpleNamespace(mesh_dim_names=("tp",))
    seen = {}

    def probe(key):
        seen[key] = (PM.current_mesh(), PM.logical_to_spec("vocab"))

    assert PM.with_current_mesh(probe) is probe      # no mesh: as it is
    with PM.use_mesh(mesh, {"vocab": None}):
        bound = PM.with_current_mesh(probe)
    for key, fn in (("plain", probe), ("bound", bound)):
        t = threading.Thread(target=fn, args=(key,))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen["plain"] == (None, PM.P("tp"))
    assert seen["bound"] == (mesh, PM.P())
