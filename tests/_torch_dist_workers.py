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
