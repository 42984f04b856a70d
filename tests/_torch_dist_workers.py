"""Rank programs for the port's multi-process tests (no JAX here).

`run_ranks` spawns one interpreter a rank, each joined with its own time
limit: a rank that raises fails the test with its traceback, a rank that
hangs is killed and fails it too. Every rank meets the others through
FileStores under the test's tmp_path (no ports, so xdist workers never
collide), runs a gloo default process group where a `DeviceMesh` is needed,
and writes what it computed to `out{rank}.pt` for the test to hold against
the JAX package.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

JOIN_S = 120.0


def _entry(fn, rank, world, tmp, args):
    try:
        torch.set_num_threads(1)
        out = fn(rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp: str, *args, timeout: float = JOIN_S
              ) -> list:
    """fn(rank, world, tmp, *args) in `world` spawned processes; returns
    their outputs by rank."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"err{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errs.append(f"rank {r}: exit code {p.exitcode}")
    if hung:
        errs.append(f"ranks {hung} did not finish within {timeout} s")
    if errs:
        raise AssertionError("\n".join(errs))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _default_group(rank, world, tmp):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "default"), world),
        rank=rank, world_size=world)


def _inputs(tmp) -> dict:
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------ collectives
def collective_ranks(rank, world, tmp):
    """Four ranks: the program bodies at Topology(2, 2), the module API on
    ranks 0 and 1, a rebuild to all four, and a DistCollectiveGroup's
    device path."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh, \
        hier_groups
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import hierarchy as H
    from ray_tpu_torch.util.collective._comm import Comm
    from ray_tpu_torch.util.collective.dist_group import lookup_membership
    from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    mesh = build_hierarchical_mesh(topology=H.Topology(2, 2),
                                   device_type="cpu")
    g = hier_groups(mesh)
    v = torch.from_numpy(inp["v"][rank])
    res = torch.from_numpy(inp["r"][rank])
    out = {"pos": (g.inter_pos, g.intra_pos)}

    # the program bodies
    out["sync_f32"] = H.hier_grad_sync(v, g)
    for dt in ("int8", "float8_e4m3fn"):
        q = QuantizedAllreduce(dtype=dt, chunk=16)
        out[f"sync_{dt}_ef"] = H.hier_grad_sync(v, g, q, residual=res)
        out[f"sync_{dt}"] = H.hier_grad_sync(v, g, q)
        shard = v[g.intra_pos * 64:(g.intra_pos + 1) * 64]
        out[f"ring_{dt}_ef"] = q.ring_allreduce(shard, g.inter, residual=res)
        out[f"gather_{dt}_ef"] = q.inter_allreduce_ef(shard, res, g.inter)
        out[f"allreduce_ef_{dt}"] = H.hier_allreduce_ef(v, res, g, q)
    p = torch.from_numpy(inp["p"][rank])
    for op in (col.ReduceOp.SUM, col.ReduceOp.PRODUCT, col.ReduceOp.MAX,
               col.ReduceOp.MIN):
        out[f"allreduce_{op.name}"] = H.hier_allreduce(p, g, op)
    out["rs"] = H.hier_reduce_scatter(v, g)
    out["rs_max"] = H.hier_reduce_scatter(v, g, col.ReduceOp.MAX)
    out["ag"] = H.hier_all_gather(out["rs"], g)
    phases = H.hier_phase_programs(g)
    out["phases"] = phases["ag"](phases["ar"](phases["rs"](v)))
    world_comm = Comm.registered(dist.group.WORLD)
    out["prod_chunked"] = H.gathered_reduce(p, world_comm, H._product,
                                            cap_bytes=256)
    out["prod_whole"] = H.gathered_reduce(p, world_comm, H._product)

    # the module API on two ranks, its byte counts, then a rebuild to four
    api = f"file://{tmp}/api"
    H.BYTES.clear()
    if rank < 2:
        col.init_collective_group(2, rank, "gloo", "api", store=api)
        api_out = {"rank": col.get_rank("api"),
                   "size": col.get_collective_group_size("api"),
                   "init": col.is_group_initialized("api"),
                   # read before the peer can leave generation 0
                   "member1_gen0": lookup_membership(
                       col.get_group("api").store, 1, wait=True)}
        x = torch.arange(6, dtype=torch.float32) + 10 * rank
        for op in col.ReduceOp:
            api_out[f"allreduce_{op.name}"] = col.allreduce(
                x.clone() + 1, op, "api")
        api_out["reduce"] = col.reduce(x.clone(), 1, group_name="api")
        api_out["broadcast"] = col.broadcast(x.clone(), 1, "api")
        lst = []
        col.allgather(lst, x.to(torch.int8), "api")
        api_out["allgather_int8"] = lst
        api_out["allgather_fp8"] = col.allgather(
            None, (x / 4).to(torch.float8_e4m3fn), "api")
        rows = torch.arange(8, dtype=torch.float32).view(2, 4) * (rank + 1)
        api_out["reducescatter"] = col.reducescatter(rows, group_name="api")
        api_out["reducescatter_max"] = col.reducescatter(
            rows, col.ReduceOp.MAX, "api")
        col.barrier("api")
        buf = torch.zeros(3)
        if rank == 0:
            col.send(torch.tensor([1.0, 2.0, 3.0]), 1, "api")
            col.recv(buf, 1, "api")
        else:
            col.recv(buf, 0, "api")
            col.send(buf * 2, 0, "api")
        api_out["sendrecv"] = buf
        grp = col.get_group("api")
        if rank == 0:
            grp.send_device(torch.full((2, 2), 7.0), 1)
        else:
            api_out["recv_device"] = grp.recv_device((2, 2), torch.float32,
                                                     0)
        api_out["bytes"] = dict(H.BYTES)
        out["api"] = api_out
    # members of generation 0 keep their store; the others open it
    col.rebuild_collective_group(4, rank, "gloo", "api",
                                 store=None if rank < 2 else api)
    new = col.get_group("api")
    t = torch.full((2,), float(rank))
    col.allreduce(t, group_name="api")
    out["rebuilt"] = {"gen": new.generation, "size": new.world_size,
                      "sum": t,
                      "member1": lookup_membership(new.store, 1, wait=True)}
    col.barrier("api")
    col.destroy_collective_group("api")

    # a DistCollectiveGroup's device path, its members published on two
    # hosts (as RAY_TPU_NODE_IP names them): a 2 x 2 topology
    os.environ["RAY_TPU_NODE_IP"] = f"host{rank // 2}"
    col.init_collective_group(4, rank, "gloo", "ddp:g0",
                              store=f"file://{tmp}/ddp")
    del os.environ["RAY_TPU_NODE_IP"]
    grp = col.get_group("ddp:g0")
    out["ddp_topology"] = (grp.topology.inter, grp.topology.intra)
    H.BYTES.clear()
    H.SAVED.clear()
    q8 = QuantizedAllreduce(dtype="int8", chunk=16)
    out["dev_f32"] = grp.allreduce_device(v)
    out["dev_avg"] = grp.allreduce_device(v, average=True)
    out["dev_max"] = grp.allreduce_device(v, col.ReduceOp.MAX)
    out["dev_int8_ef"] = [grp.allreduce_device(v, quantize=q8)
                          for _ in range(2)]
    out["dev_odd"] = grp.allreduce_device(v[:99].to(torch.bfloat16))
    out["dev_bytes"] = (dict(H.BYTES), dict(H.SAVED))
    tree = {"b": v[:5].clone(), "a": {"w": v[5:11].view(2, 3).clone()}}
    out["tree_avg"] = spmd.cross_worker_grad_sync(tree, "ddp:g0", 4)
    out["tree_world1"] = spmd.cross_worker_grad_sync(tree, "ddp:g0", 1)
    col.destroy_collective_group("ddp:g0")

    # a group without a topology: every rank is on this host
    col.init_collective_group(4, rank, "gloo", "host",
                              store=f"file://{tmp}/host")
    topo = col.get_group("host").topology
    out["inferred"] = (topo.inter, topo.intra)
    col.destroy_collective_group("host")
    dist.destroy_process_group()
    return out


# ------------------------------------------------- NCCL across several cards
def nccl_cards(rank, world, tmp):
    """One rank a card over NCCL, as two hosts of world/2: the quantized ring
    (each hop's send and recv to the one peer grouped) and the gather
    exchange on the inter group, the fused sync with error feedback, a
    DistCollectiveGroup's device path and point-to-point calls, then
    gpt2-tiny data parallel in f32 and int8 with error feedback."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh, \
        hier_groups
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import hierarchy as H
    from ray_tpu_torch.util.collective._comm import HOST_STAGED
    from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    inp = _inputs(tmp)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "default"), world),
        rank=rank, world_size=world, device_id=dev)
    topo = H.Topology(2, world // 2)
    mesh = build_hierarchical_mesh(topology=topo)
    g = hier_groups(mesh)
    v = torch.from_numpy(inp["v"][rank]).to(dev)
    res = torch.from_numpy(inp["r"][rank]).to(dev)
    q = QuantizedAllreduce(dtype="int8", chunk=16)
    per = v.numel() // topo.intra
    shard = v[g.intra_pos * per:(g.intra_pos + 1) * per]
    out = {"pos": (g.inter_pos, g.intra_pos)}
    out["ring"] = q.ring_allreduce(shard, g.inter, residual=res)
    out["gather"] = q.inter_allreduce_ef(shard, res, g.inter)
    # 4 MiB a hop: past what NCCL sends before its peer's recv is posted
    big = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        1 << 20, dtype=np.float32)).to(dev)
    out["ring_big"] = (q.ring_allreduce(big, g.inter),
                       q.inter_allreduce(big, g.inter))
    out["sync_ef"] = H.hier_grad_sync(v, g, q, residual=res)
    out["sync_f32"] = H.hier_grad_sync(v, g)

    os.environ["RAY_TPU_NODE_IP"] = f"host{rank // topo.intra}"
    col.init_collective_group(world, rank, "nccl", "cards",
                              store=f"file://{tmp}/cards")
    del os.environ["RAY_TPU_NODE_IP"]
    grp = col.get_group("cards")
    out["grp_topology"] = (grp.topology.inter, grp.topology.intra)
    out["dev_int8_ef"] = grp.allreduce_device(v, quantize=q)
    out["dev_f32"] = grp.allreduce_device(v)
    if rank == 0:
        grp.send_device(torch.full((2, 2), 7.0, device=dev), 1)
        out["p2p"] = grp.recv_device((3,), torch.float32, 1)
    elif rank == 1:
        got = grp.recv_device((2, 2), torch.float32, 0)
        grp.send_device(got[0, :1].repeat(3) * 2, 0)
        out["p2p"] = got
    grp.barrier()
    col.destroy_collective_group("cards")

    # gpt2-tiny data parallel against one device at the global batch
    cfg = gpt2.GPT2Config.preset("gpt2-tiny", dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(inp["tokens"]).to(dev)}
    staged = HOST_STAGED["bytes"]
    for name, m, quant in (("one device", None, None), ("f32", mesh, None),
                           ("int8-ef", mesh,
                            QuantizedAllreduce(dtype="int8", chunk=64))):
        opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
        train = spmd.compile_gpt2_train(cfg, mesh=m, optimizer=opt,
                                        device=dev, grad_quantize=quant)
        state = train.init_fn(torch.Generator().manual_seed(0))
        ef = train.init_ef_fn() if quant is not None else None
        hist = []
        for _ in range(4):
            if ef is None:
                state, met = train.step_fn(state, batch)
            else:
                state, met, ef = train.step_fn(state, batch, ef)
            hist.append((float(met["loss"]), float(met["grad_norm"])))
        out[name] = (hist, gpt2.params_to_numpy(state.params))
    out["staged"] = HOST_STAGED["bytes"] - staged
    dist.destroy_process_group()
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else
                tuple(t.cpu() for t in v) if isinstance(v, tuple)
                and isinstance(v[0], torch.Tensor) else v)
            for k, v in out.items()}


# ---------------------------------------------------------- data parallel
class SGD:
    """optax.sgd(lr) for compile_train, in place."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, params, grads, state):
        from ray_tpu_torch.train import spmd

        for p, g in zip(spmd._leaves(params), spmd._leaves(grads)):
            p.sub_(self.lr * g)
        return spmd.global_norm(grads)


def _gpt2_run(mesh, inp, **kw):
    """A data-parallel gpt2-tiny program, its state from the JAX package's
    weights, and the global batch."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd

    cfg = gpt2.GPT2Config.preset("gpt2-tiny", dtype=torch.float32)
    opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
    train = spmd.compile_gpt2_train(cfg, mesh=mesh, optimizer=opt,
                                    device="cpu", **kw)
    flat = {k[len("w/"):]: v for k, v in inp.items() if k.startswith("w/")}
    params = gpt2.params_from_numpy(flat, cfg, device="cpu")
    state = spmd.TrainState(0, params, opt.init(params))
    return train, state, {"tokens": inp["tokens"]}


def _trajectory(train, state, batch, steps):
    from ray_tpu_torch.models import gpt2

    hist = []
    for _ in range(steps):
        state, m = train.step_fn(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return hist, gpt2.params_to_numpy(state.params)


def dp_two_ranks(rank, world, tmp):
    """Topology(2, 1): the trajectory, sync_fn against grad_fn and the
    grads' own sync, and the timed step against the fused one."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh, \
        hier_groups
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective.hierarchy import Topology, \
        hier_grad_sync

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    mesh = build_hierarchical_mesh(topology=Topology(2, 1),
                                   device_type="cpu")
    out = {}
    train, state, batch = _gpt2_run(mesh, inp, phase_timing=True)
    loss_s, g_s = train.sync_fn(state, batch)
    loss_g, g_g = train.grad_fn(state, batch)
    rows = {k: v[rank * 2:(rank + 1) * 2] for k, v in batch.items()}
    local = spmd.compile_gpt2_train(
        gpt2.GPT2Config.preset("gpt2-tiny", dtype=torch.float32),
        device="cpu").grad_fn(state, rows)[1]
    # this rank's own grads through the two-level sum, averaged
    leaves = spmd._leaves(local)
    vec = hier_grad_sync(torch.cat([g.reshape(-1) for g in leaves]),
                         hier_groups(mesh)) / world
    pieces = iter(vec.split([g.numel() for g in leaves]))
    own = spmd._tree_map(lambda g: next(pieces).view(g.shape), local)
    out["sync"] = (float(loss_s), gpt2.params_to_numpy(g_s),
                   float(loss_g), gpt2.params_to_numpy(g_g),
                   gpt2.params_to_numpy(own))
    out["hist"], out["params"] = _trajectory(train, state, batch, 4)

    # one timed step and one fused step from the same weights
    finals = []
    for timed in (False, True):
        train, state, batch = _gpt2_run(mesh, inp, phase_timing=True)
        fn = train.timed_step_fn if timed else train.step_fn
        state, m = fn(state, batch)
        finals.append((gpt2.params_to_numpy(state.params), float(m["loss"]),
                       m.get("phases")))
    out["timed"] = finals
    dist.destroy_process_group()
    return out


def dp_four_ranks(rank, world, tmp):
    """Topology(2, 2): the gpt2-tiny trajectory, and the quadratic fit of
    the JAX package's EF test, f32 and int8 with error feedback."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective.hierarchy import Topology
    from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    mesh = build_hierarchical_mesh(topology=Topology(2, 2),
                                   device_type="cpu")
    out = {}
    train, state, batch = _gpt2_run(mesh, inp)
    out["hist"], out["params"] = _trajectory(train, state, batch, 4)

    def loss_fn(params, b):
        pred = b["x"][:, :-1] @ params["w"]
        return torch.mean((pred - b["x"][:, -1]) ** 2)

    def init_params(generator, device):
        w = ((np.arange(8) % 5) - 2) / 4.0
        return {"w": torch.tensor(w, dtype=torch.float32, device=device)}

    qbatch = {"x": inp["quad"]}
    for name, q in (("f32", None),
                    ("int8_ef", QuantizedAllreduce(dtype="int8", chunk=64,
                                                   error_feedback=True))):
        ct = spmd.compile_train(loss_fn, init_params, mesh=mesh,
                                optimizer=SGD(0.1), device="cpu",
                                grad_quantize=q)
        st = ct.init_fn(torch.Generator())
        ef = ct.init_ef_fn() if ct.init_ef_fn is not None else None
        losses = []
        for _ in range(100):
            if ef is None:
                st, m = ct.step_fn(st, qbatch)
            else:
                st, m, ef = ct.step_fn(st, qbatch, ef)
            losses.append(float(m["loss"]))
        out[f"quad_{name}"] = (losses, st.params["w"].clone(),
                               None if ef is None else ef.shape)
    dist.destroy_process_group()
    return out


# ------------------------------- the hierarchical mesh composed with others
def hier_trajectory(name, config, topo, inp, steps, impl="auto",
                    quantize=None, device="cpu", seen=None):
    """`steps` steps of family `name` through compile_model_train on
    build_hierarchical_mesh(config, Topology(*topo)), from the numpy
    weights inp["w/<name>/..."] and tokens inp["tokens"]: ([(loss,
    grad_norm, step)], gathered final params, step 2's plain kernel calls
    on this rank when `seen` (the Counter `_count_plain` fills) is given).
    `quantize`: "int8_ef" for the int8 inter hop with error feedback."""
    from ray_tpu_torch.parallel.mesh import (build_hierarchical_mesh,
                                             model_submesh, use_mesh)
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective.hierarchy import Topology
    from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

    mod, cfg = family(name, attn_impl=impl)
    mesh = build_hierarchical_mesh(config, Topology(*topo),
                                   device_type=device)
    q = (QuantizedAllreduce(dtype="int8", chunk=64, error_feedback=True)
         if quantize == "int8_ef" else None)
    opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
    train = spmd.compile_model_train(mod, cfg, mesh=mesh, optimizer=opt,
                                     device=device, grad_quantize=q)
    with use_mesh(model_submesh(mesh)):
        specs = mod.param_specs(cfg)
    params = spmd.shard_params(
        mod.params_from_numpy(pipe_weights(inp, name), cfg, device),
        model_submesh(mesh), specs)
    state = spmd.TrainState(0, params, opt.init(params))
    ef = None
    if train.init_ef_fn is not None:   # the residual is sized by init_fn
        train.init_fn(torch.Generator())
        ef = train.init_ef_fn()
    batch = {"tokens": inp["tokens"]}
    hist, calls = [], {}
    for i in range(steps):
        if seen is not None:
            seen.clear()
        if ef is None:
            state, m = train.step_fn(state, batch)
        else:
            state, m, ef = train.step_fn(state, batch, ef)
        if seen is not None and i == 1:
            calls = dict(seen)
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return hist, mod.params_to_numpy(spmd.unshard(state.params)), calls


def hier_ranks(rank, world, tmp, runs, steps):
    """Each run (name, config, (inter, intra), impl, quantize) as a
    `hier_trajectory` (final params on rank 0 only); then, on the first
    run's mesh, one timed step against one fused step from the same
    weights (params gathered, the timed step's phases)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective.hierarchy import Topology

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    seen = _count_plain()
    out = {}
    for run in runs:
        hist, params, calls = hier_trajectory(*run[:3], inp, steps, *run[3:],
                                              seen=seen)
        out[hier_key(*run)] = (hist, params if rank == 0 else None, calls)
    name, config, topo = runs[0][:3]
    mod, cfg = family(name)
    mesh = build_hierarchical_mesh(config, Topology(*topo),
                                   device_type="cpu")
    finals = []
    for timed in (False, True):
        opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
        train = spmd.compile_model_train(mod, cfg, mesh=mesh, optimizer=opt,
                                         device="cpu", phase_timing=True)
        state = train.init_fn(torch.Generator().manual_seed(0))
        fn = train.timed_step_fn if timed else train.step_fn
        state, m = fn(state, {"tokens": inp["tokens"]})
        finals.append((mod.params_to_numpy(spmd.unshard(state.params)),
                       float(m["loss"]), m.get("phases")))
    out["timed"] = finals
    dist.destroy_process_group()
    return out


def hier_key(name, config, topo, impl="auto", quantize=None) -> tuple:
    return (name, tuple(sorted(config.items())), tuple(topo), impl, quantize)


# ------------------------------------------------- meshes of dp/fsdp/tp/ep
FAMILIES = {"gpt2": ("gpt2", "GPT2Config", "gpt2-tiny"),
            "llama": ("llama", "LlamaConfig", "llama-tiny"),
            "moe": ("moe", "MoEConfig", "moe-tiny")}


def family(name, **overrides):
    """(model module, its f32 tiny config) of the port."""
    import importlib

    mod_name, cls, preset = FAMILIES[name]
    mod = importlib.import_module(f"ray_tpu_torch.models.{mod_name}")
    return mod, getattr(mod, cls).preset(preset, dtype=torch.float32,
                                         **overrides)


def sharded_state(mod, cfg, flat, mesh, opt, device="cpu"):
    """The port's TrainState from numpy leaves, placed by param_specs."""
    from ray_tpu_torch.parallel.mesh import use_mesh
    from ray_tpu_torch.train import spmd

    with use_mesh(mesh):
        specs = mod.param_specs(cfg)
    params = spmd.shard_params(mod.params_from_numpy(flat, cfg, device),
                               mesh, specs)
    return spmd.TrainState(0, params, opt.init(params))


def mesh_trajectory(name, config, inp, steps=4, device="cpu", comm=None,
                    attn_impl="dense", seen=None, calls=None):
    """`steps` steps of family `name` through compile_model_train on
    build_mesh(config), from the numpy weights inp["w/<name>/..."]:
    ([(loss, grad_norm, step)], gathered final params). With `comm` a
    dict, step 2's collective counts by kind (CommDebugMode) go into it;
    with `seen` (the Counter `_count_plain` fills), step 2's plain kernel
    calls go into the dict `calls`."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.train import spmd

    mod, cfg = family(name, attn_impl=attn_impl)
    mesh = build_mesh(config, device_type=device)
    opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
    train = spmd.compile_model_train(mod, cfg, mesh=mesh, optimizer=opt,
                                     device=device)
    prefix = f"w/{name}/"
    flat = {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}
    state = sharded_state(mod, cfg, flat, mesh, opt, device)
    batch = {"tokens": inp["tokens"]}
    hist = []
    for i in range(steps):
        if comm is not None and i == 1:
            with CommDebugMode() as mode:
                state, m = train.step_fn(state, batch)
            comm.update({str(k).rsplit(".", 1)[-1]: v for k, v in
                         mode.get_comm_counts().items()})
        elif seen is not None and i == 1:
            seen.clear()
            state, m = train.step_fn(state, batch)
            calls.update(seen)
        else:
            state, m = train.step_fn(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return hist, mod.params_to_numpy(spmd.unshard(state.params))


def _flash_on_shards(mesh, seed=0):
    """flash_attention on DTensors [B, H, T, Dh] sharded (batch on dp, heads
    on tp) against the unsharded call: (out, dq, dk, dv) both ways, and the
    shapes the three plain versions saw."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import P, spec_to_placements

    seen = []
    for name in ("flash_attention_reference", "_bwd_dq_reference",
                 "_bwd_dkv_reference"):
        orig = getattr(fa, name)

        def spy(q, *a, _orig=orig, _name=name, **kw):
            seen.append((_name, tuple(q.shape)))
            return _orig(q, *a, **kw)
        setattr(fa, name, spy)
    g = torch.Generator().manual_seed(seed)
    full = [torch.randn(4, 4, 64, 32, generator=g) for _ in range(4)]
    placements = spec_to_placements(mesh, P("dp", "tp"))
    sharded = [distribute_tensor(t, mesh, placements).requires_grad_()
               for t in full[:3]]
    out = fa.flash_attention(*sharded, True)
    grads = torch.autograd.grad(out, sharded,
                                distribute_tensor(full[3], mesh, placements))
    local_seen = list(seen)
    plain = [t.clone().requires_grad_() for t in full[:3]]
    want = fa.flash_attention(*plain, True)
    want_grads = torch.autograd.grad(want, plain, full[3])
    return (tuple(t.full_tensor().detach() for t in (out, *grads)),
            (want.detach(), *want_grads), local_seen)


def mesh_four_ranks(rank, world, tmp, runs, extras=True):
    """Four ranks: each (name, mesh config) of `runs` as a 4-step
    trajectory; with `extras`, flash on local head shards, chunked
    cross-entropy against the plain one on a mesh, and local_window against
    DTensor's own shards."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ray_tpu_torch.parallel.mesh import build_mesh, local_window
    from ray_tpu_torch.train import spmd

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    out = {}
    for name, config in runs:
        hist, params = mesh_trajectory(name, config, inp)
        out[(name, tuple(sorted(config.items())))] = (
            hist, params if rank == 0 else None)
    if not extras:
        dist.destroy_process_group()
        return out

    mesh = build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    out["flash"] = _flash_on_shards(mesh)

    # chunked cross-entropy on a mesh: the same loss and gradients
    flat = {k[len("w/gpt2/"):]: v for k, v in inp.items()
            if k.startswith("w/gpt2/")}
    fmesh = build_mesh({"fsdp": 2, "tp": 2}, device_type="cpu")
    ce = []
    for chunk in (0, 16):
        mod, cfg = family("gpt2", attn_impl="dense", ce_chunk=chunk)
        opt = spmd.default_optimizer()
        train = spmd.compile_model_train(mod, cfg, mesh=fmesh, optimizer=opt,
                                         device="cpu")
        state = sharded_state(mod, cfg, flat, fmesh, opt)
        loss, grads = train.grad_fn(state, {"tokens": inp["tokens"]})
        ce.append((float(loss), mod.params_to_numpy(spmd.unshard(grads))))
    out["chunked_ce"] = ce

    # the backward from another thread, as the autograd engine runs that of
    # CUDA tensors: the checkpointed blocks' recompute must shard as the
    # forward did
    import threading

    from ray_tpu_torch.parallel.mesh import use_mesh

    mod, cfg = family("gpt2", attn_impl="dense", remat=True)
    state = sharded_state(mod, cfg, flat, mesh, spmd.default_optimizer())
    params = spmd._tree_map(lambda p: p.detach().requires_grad_(),
                            state.params)
    batch = spmd._Sharded(mesh).batch(
        {"tokens": inp["tokens"]})
    grads = []
    with use_mesh(mesh):
        loss = mod.loss_fn(params, batch, cfg)
    for _ in range(2):
        t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(
            loss, spmd._leaves(params), retain_graph=True)))
        t.start()
        t.join(60)
    out["thread_grads"] = len(grads) == 2 and all(
        torch.equal(a.full_tensor(), b.full_tensor())
        for a, b in zip(*grads))

    # this rank's window as DTensor lays its shards out, uneven ones too
    windows = []
    for shape in ((7, 5), (4, 9), (3, 2)):
        t = torch.arange(float(np.prod(shape))).reshape(shape)
        for placements in ((Shard(0), Shard(1)), (Shard(1), Shard(0)),
                           (Shard(0), Shard(0)), (Replicate(), Shard(1))):
            local = distribute_tensor(t, mesh, placements).to_local()
            windows.append(torch.equal(
                t[local_window(shape, mesh, placements)], local))
    out["windows"] = windows
    dist.destroy_process_group()
    return out


def mesh_two_ranks(rank, world, tmp):
    """Two ranks: gpt2-tiny on a flat dp=2 mesh (the trajectory) and on a
    tp=2 mesh (the trajectory and step 2's collective counts)."""
    import torch.distributed as dist

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    out = {"dp": mesh_trajectory("gpt2", {"dp": 2}, inp)}
    comm = {}
    out["tp"] = mesh_trajectory("gpt2", {"tp": 2}, inp, comm=comm)
    out["tp_comm"] = comm
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------- resharding
def reshard_ranks(rank, world, tmp):
    """Four ranks: reshard from the host, on one mesh and across meshes,
    scalars and trees; reshard_streaming from an array and from a
    WindowedReader, with its stats. Returns each result's local shard (and
    its full tensor where the test reads it whole)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.parallel.mesh import (P, Sharding, build_mesh,
                                             spec_to_placements)
    from ray_tpu_torch.util.collective import reshard as R

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    x, big = inp["x"], inp["big"]
    mesh4 = build_mesh({"dp": 4}, device_type="cpu")
    mesh22 = build_mesh({"fsdp": 2, "tp": 2}, device_type="cpu")
    rows = Sharding(mesh4, (Shard(0),))
    out = {}
    a = R.reshard(x, rows)
    b = R.reshard(a, Sharding(mesh4, (Shard(1),)))
    c = R.reshard(b, Sharding(mesh22, spec_to_placements(mesh22,
                                                         P("fsdp", "tp"))))
    d = R.reshard(torch.from_numpy(x), Sharding(
        mesh22, spec_to_placements(mesh22, P(None, ("fsdp", "tp")))))
    for name, t in (("host", a), ("same_mesh", b), ("cross_mesh", c),
                    ("tensor", d)):
        out[name] = (t.to_local().clone(), tuple(t.placements),
                     t.full_tensor())
    s = R.reshard(np.float32(5.0), Sharding(mesh22, (Replicate(),) * 2))
    out["scalar"] = (tuple(s.shape), float(s.full_tensor()))
    tree = R.reshard_tree({"a": x, "b": x.T.copy()},
                          Sharding(mesh4, (Replicate(),)))
    out["tree"] = {k: v.full_tensor() for k, v in tree.items()}
    per_leaf = R.reshard_tree({"a": x, "b": {"c": x.T.copy()}},
                              {"a": rows, "b": {"c": Sharding(
                                  mesh4, (Shard(1),))}})
    out["tree_per_leaf"] = (per_leaf["a"].to_local().clone(),
                            per_leaf["b"]["c"].to_local().clone())

    chunk_bytes = 64 * 1024   # the leaf is 512 KB, a window 128 KB
    st = R.reshard_streaming(big, rows, chunk_bytes=chunk_bytes,
                             max_in_flight=2)
    out["stream"] = (st.to_local().clone(), dict(R.last_stream_stats),
                     R.reshard(big, rows).to_local().clone())
    rep = R.reshard_streaming(big, Sharding(mesh4, (Replicate(),)),
                              chunk_bytes=chunk_bytes, max_in_flight=2)
    out["stream_rep"] = (rep.to_local().clone(), dict(R.last_stream_stats))
    blocks = [(((0, 300), (0, 128)), "a"), (((300, 1024), (0, 128)), "b")]
    parts = {"a": big[:300], "b": big[300:]}
    reader = R.WindowedReader(big.shape, big.dtype, blocks,
                              lambda k, r0, r1: parts[k][r0:r1])
    cols = Sharding(mesh22, spec_to_placements(mesh22, P("tp", "fsdp")))
    rd = R.reshard_streaming(reader, cols, chunk_bytes=4096,
                             max_in_flight=3, out_dtype=np.float64)
    out["reader"] = (rd.to_local().clone(), dict(R.last_stream_stats),
                     R.reshard(big.astype(np.float64), cols).to_local()
                     .clone())
    dist.destroy_process_group()
    return out


def mesh_cards(rank, world, tmp):
    """One rank a card over NCCL: gpt2-tiny on dp=2,tp=2 and fsdp=2,tp=2
    and moe-tiny on ep=4 in f32 (the CPU tests' trajectories), then one
    bf16 gpt2-tiny step on dp=2,tp=2 through the flash kernels, counting
    each kernel's launches on this rank."""
    import dataclasses

    import torch.distributed as dist

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.train import spmd

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "default"), world),
        rank=rank, world_size=world, device_id=dev)
    inp = _inputs(tmp)
    out = {}
    for name, config in (("gpt2", {"dp": 2, "tp": 2}),
                         ("gpt2", {"fsdp": 2, "tp": 2}), ("moe", {"ep": 4})):
        out[(name, tuple(sorted(config.items())))] = mesh_trajectory(
            name, config, inp, device="cuda")
    mod, cfg = family("gpt2", attn_impl="flash")
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    mesh = build_mesh({"dp": 2, "tp": 2})
    opt = spmd.default_optimizer()
    train = spmd.compile_model_train(mod, cfg, mesh=mesh, optimizer=opt)
    flat = {k[len("w/gpt2/"):]: v for k, v in inp.items()
            if k.startswith("w/gpt2/")}
    state = sharded_state(mod, cfg, flat, mesh, opt, "cuda")
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    state, m = train.step_fn(state, {"tokens": inp["tokens"]})
    after = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    out["bf16"] = (tuple(a - b for a, b in zip(after, before)),
                   float(m["loss"]), float(m["grad_norm"]))
    dist.destroy_process_group()
    return out


# ------------------------------------------ sequence parallel (ring, Ulysses)
def _count_plain():
    """Wrap the flash kernels' plain versions with call counters (the CPU
    path counts no launches): returns the Counter they fill."""
    import collections

    from ray_tpu_torch.ops import flash_attention as fa

    seen = collections.Counter()
    for name in ("flash_attention_reference", "_bwd_dq_reference",
                 "_bwd_dkv_reference"):
        orig = getattr(fa, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen[_name] += 1
            return _orig(*a, **kw)
        setattr(fa, name, spy)
    return seen


def ring_ranks(rank, world, tmp, cases):
    """Each case (impl, mesh config, causal, (T, Dh)): ring or Ulysses
    attention on DTensors of the seeded q, k, v of that shape (inputs
    "q{T}x{Dh}", ...) sharded (batch, heads, seq, None), its gradients
    against dO, the bytes accounted and the plain kernels' calls on this
    rank. Then the shape contract on the first case's mesh: what a head
    dim past 128 and a sequence that sp does not divide raised."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops import ring_attention as R
    from ray_tpu_torch.parallel.mesh import (build_mesh, logical_to_spec,
                                             spec_to_placements, use_mesh)
    from ray_tpu_torch.util.collective import hierarchy as H

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    seen = _count_plain()
    out = {}
    for impl, config, causal, (T, Dh) in cases:
        mesh = build_mesh(config, device_type="cpu")
        placements = spec_to_placements(
            mesh, logical_to_spec("batch", "heads", "seq", None))
        q, k, v, do = (distribute_tensor(torch.from_numpy(inp[f"{n}{T}x{Dh}"]),
                                         mesh, placements)
                       for n in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        H.BYTES.clear()
        seen.clear()
        with use_mesh(mesh):
            o = getattr(R, f"{impl}_attention")(q, k, v, causal=causal)
        grads = torch.autograd.grad(o, (q, k, v), do)
        out[(impl, tuple(sorted(config.items())), causal, (T, Dh))] = dict(
            out=o.full_tensor().detach(),
            grads=[g.full_tensor() for g in grads], bytes=dict(H.BYTES),
            calls=dict(seen), sp_rank=mesh.get_group("sp").rank())
    mesh = build_mesh(cases[0][1], device_type="cpu")
    sp = cases[0][1]["sp"]
    out["contract"] = []
    for T, Dh in ((32 * sp, 320), (32 * sp + 1, 32)):
        q = torch.zeros(2, 4, T, Dh)
        try:
            with use_mesh(mesh):
                R.ring_attention(q, q, q)
            out["contract"].append(None)
        except ValueError as e:
            out["contract"].append(str(e))
    dist.destroy_process_group()
    return out


def sp_trajectory_ranks(rank, world, tmp, runs):
    """Each (name, mesh config, attn_impl) of `runs` as a 3-step
    trajectory from the numpy weights inp["w/<name>/..."]; with the plain
    kernels' calls in step 2 counted on this rank."""
    import torch.distributed as dist

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    seen = _count_plain()
    out = {}
    for name, config, impl in runs:
        calls = {}
        hist, params = mesh_trajectory(name, config, inp, steps=3,
                                       attn_impl=impl, seen=seen,
                                       calls=calls)
        out[(name, tuple(sorted(config.items())), impl)] = (
            hist, params if rank == 0 else None, calls)
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------- checkpoints
def state_numpy(state) -> dict:
    """{leaf key: numpy copy} of a TrainState as `save_state_sharded` keys
    it, DTensors gathered (a collective: every rank calls it). A copy: the
    step updates the state in place, and a replicated DTensor's
    full_tensor is its local tensor."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.checkpoint import (_flatten_with_path, _host,
                                               _leaf_key)

    out = {}
    for kp, leaf in _flatten_with_path(spmd._state_as_tree(state)):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        out[_leaf_key(kp)] = (_host(leaf).copy()      # bf16 as its bits
                              if isinstance(leaf, torch.Tensor)
                              else np.int32(leaf))
    return out


def _ckpt_train(config, impl="dense", device="cpu"):
    """gpt2-tiny's program on build_mesh(config) (one device for None)."""
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.train import spmd

    mod, cfg = family("gpt2", attn_impl=impl)
    mesh = build_mesh(config, device_type=device) if config else None
    opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
    return spmd.compile_model_train(mod, cfg, mesh=mesh, optimizer=opt,
                                    device=device)


def _steps(train, state, tokens, n):
    losses = []
    for _ in range(n):
        state, m = train.step_fn(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return state, losses


def checkpoint_ranks(rank, world, tmp):
    """Two ranks:
    - the JAX package's checkpoint in tmp/jax restored on fsdp=2,
      gathering and streaming;
    - gpt2-tiny on fsdp=2: 2 steps, saved to tmp/port-fsdp (both ranks),
      then the unbroken 3rd step against a restore, gathering and
      streaming, and its 3rd step;
    - on sp=2 (ring attention): 2 steps, saved to tmp/port-sp;
    - 2 -> 1 -> 2: rank 0 restores tmp/port-fsdp onto one device and saves
      it at world 1 to tmp/port-one; both ranks restore that on tp=2."""
    import torch.distributed as dist

    from ray_tpu_torch.train import spmd

    inp = _inputs(tmp)
    tokens = inp["tokens"]
    _default_group(rank, world, tmp)
    out = {}
    train = _ckpt_train({"fsdp": 2})
    out["jax"] = [state_numpy(spmd.restore_state_sharded(
        os.path.join(tmp, "jax"), train, **kw))
        for kw in ({}, {"stream_chunk_bytes": 4096})]

    state = train.init_fn(torch.Generator().manual_seed(0))
    state, losses = _steps(train, state, tokens, 2)
    path = os.path.join(tmp, "port-fsdp")
    spmd.save_state_sharded(state, path, world_size=world,
                            process_index=rank)
    out["fsdp_saved"] = state_numpy(state)
    state, last = _steps(train, state, tokens, 1)
    out["fsdp_unbroken"] = (losses + last, state_numpy(state))
    dist.barrier()
    resumed = []
    for kw in ({}, {"stream_chunk_bytes": 1024, "stream_in_flight": 3}):
        got = spmd.restore_state_sharded(path, train, **kw)
        restored = state_numpy(got)
        got, loss = _steps(train, got, tokens, 1)
        resumed.append((restored, loss, state_numpy(got)))
    out["fsdp_resumed"] = resumed

    sp_train = _ckpt_train({"sp": 2}, impl="auto")
    state = sp_train.init_fn(torch.Generator().manual_seed(0))
    state, out["sp_losses"] = _steps(sp_train, state, tokens, 2)
    spmd.save_state_sharded(state, os.path.join(tmp, "port-sp"),
                            world_size=world, process_index=rank)
    out["sp_saved"] = state_numpy(state)

    one = os.path.join(tmp, "port-one")
    if rank == 0:
        single = _ckpt_train(None)
        spmd.save_state_sharded(spmd.restore_state_sharded(path, single),
                                one)
    dist.barrier()
    out["two_one_two"] = state_numpy(spmd.restore_state_sharded(
        one, _ckpt_train({"tp": 2})))
    dist.destroy_process_group()
    return out


# -------------------------------------------------------------- pipelines
PIPE_M = 4          # microbatches


def pipe_family(name, impl="auto"):
    """(module, f32 config) of the JAX package's pipeline tests: gpt2-tiny
    at 4 layers, llama-tiny, no remat; attention by `impl` (auto: ring on a
    mesh with sp)."""
    return family(name, remat=False, attn_impl=impl,
                  **({"n_layer": 4} if name == "gpt2" else {}))


def pipe_run(run) -> tuple:
    """A pipeline test's run, (name, config) or (name, config, impl), as
    (name, config, impl)."""
    name, config, *impl = run
    return name, config, (impl or ["auto"])[0]


def pipe_key(kind, name, config, impl="auto") -> tuple:
    return (kind, name, tuple(sorted(config.items())), impl)


def pipe_params(mod, cfg, flat, mesh):
    """Params from numpy leaves, placed by param_specs under the rule
    "layers": "pp" (each stage's layers on its pp ranks)."""
    from ray_tpu_torch.parallel.mesh import use_mesh
    from ray_tpu_torch.train import spmd

    with use_mesh(mesh, {"layers": "pp"}):
        specs = mod.param_specs(cfg)
    return spmd.shard_params(mod.params_from_numpy(flat, cfg, "cpu"), mesh,
                             specs)


def pipe_logits(mod, cfg, params, tokens, F, mesh=None):
    """embed -> pipeline_apply (PIPE_M microbatches, F stages) -> unembed,
    without gradients, as the JAX package's pipeline tests run it; logits
    gathered."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import pipeline as PP
    from ray_tpu_torch.parallel.mesh import use_mesh

    stage_fn = PP.make_stage_fn(lambda x, bp: mod._block(x, bp, cfg),
                                remat=False)
    with torch.no_grad(), use_mesh(mesh, {"layers": "pp"}):
        x = mod.embed(params, tokens, cfg)
        x = PP.pipeline_apply(stage_fn, PP.stack_stages(params["blocks"], F),
                              x, n_microbatches=PIPE_M, mesh=mesh)
        out = mod.unembed(params, x, cfg)
    return out.full_tensor() if isinstance(out, DTensor) else out


def pipe_weights(inp, name) -> dict:
    prefix = f"w/{name}/"
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def pipe_train(name, mesh, opt, impl="auto"):
    """compile_pipeline_train of family `name` on `mesh` (a build_mesh
    mesh, or a MeshConfig of pp alone)."""
    from ray_tpu_torch.train import spmd

    mod, cfg = pipe_family(name, impl)
    return mod, cfg, spmd.compile_pipeline_train(mod, cfg, mesh, PIPE_M,
                                                 optimizer=opt, device="cpu")


def pipeline_ranks(rank, world, tmp, fwd, traj, steps, restore=None):
    """Each run (`pipe_run`) of `fwd`: the pipelined logits from the numpy
    weights inp["w/<name>/..."], with the bytes accounted and the flash
    kernels' plain versions' calls on this rank; of `traj`: `steps` steps
    through compile_pipeline_train ([(loss, grad_norm, step)], gathered
    params on rank 0, step 2's plain kernel calls on this rank). On two
    ranks (pp=2), also gpt2's loss and gathered gradients at those weights
    (grad_fn), and its state after the trajectory saved to tmp/port-pp
    with both ranks' leaves. With `restore` (a checkpoint of gpt2's
    state), it restored onto the first gpt2 trajectory's program, leaves
    gathered."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import axis_size, build_mesh
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective import hierarchy as H

    inp = _inputs(tmp)
    _default_group(rank, world, tmp)
    seen = _count_plain()
    tokens = torch.from_numpy(inp["tokens"])
    out = {}
    for run in fwd:
        name, config, impl = pipe_run(run)
        mod, cfg = pipe_family(name, impl)
        mesh = build_mesh(config, device_type="cpu")
        params = pipe_params(mod, cfg, pipe_weights(inp, name), mesh)
        seen.clear()
        H.BYTES.clear()
        logits = pipe_logits(mod, cfg, params, tokens[:, :-1],
                             axis_size(mesh, "pp"), mesh)
        out[pipe_key("fwd", name, config, impl)] = (logits, dict(H.BYTES),
                                                    dict(seen))
    for run in traj:
        name, config, impl = pipe_run(run)
        mesh = build_mesh(config, device_type="cpu")
        opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
        mod, cfg, train = pipe_train(name, mesh, opt, impl)
        if restore is not None and name == "gpt2" and "restored" not in out:
            out["restored"] = state_numpy(spmd.restore_state_sharded(
                restore, train))
        params = pipe_params(mod, cfg, pipe_weights(inp, name), mesh)
        state = spmd.TrainState(0, params, opt.init(params))
        key = pipe_key("traj", name, config, impl)
        if world == 2:
            loss, grads = train.grad_fn(state, {"tokens": tokens})
            out["grads"] = (loss.item(),
                            mod.params_to_numpy(spmd.unshard(grads)))
        hist, calls = [], {}
        for i in range(steps):
            seen.clear()
            state, m = train.step_fn(state, {"tokens": tokens})
            if i == 1:
                calls = dict(seen)
            hist.append((float(m["loss"]), float(m["grad_norm"]),
                         m["step"]))
        end = mod.params_to_numpy(spmd.unshard(state.params))
        out[key] = (hist, end if rank == 0 else None, calls)
        if world == 2:
            spmd.save_state_sharded(state, os.path.join(tmp, "port-pp"),
                                    world_size=world, process_index=rank)
            out["saved"] = state_numpy(state)
    dist.destroy_process_group()
    return out
