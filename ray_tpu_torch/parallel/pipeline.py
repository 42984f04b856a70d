"""Pipeline parallelism: the GPipe microbatch pipeline over the `pp` mesh
axis (counterpart of the GPipe half of `ray_tpu/parallel/pipeline.py`).

The JAX package keeps the pipeline inside one XLA program: a `shard_map`
manual over `pp`, a `lax.scan` over M + F - 1 ticks and a `lax.ppermute`
hop a tick. Here each stage's schedule is a Python generator, as the
ring's are (`ops.ring_attention`), and what drives it decides where the
stages run:
- on a `build_mesh` mesh with pp = F > 1, one rank a stage: every tick's
  hop is a grouped send/recv over the pp group (`Comm.exchange`, NCCL
  across cards, gloo on the CPU) along `hierarchy.ring_perm(F)`, the wrap
  hop included;
- with no mesh, the F stages of `stage_params` (leading dim F) run in this
  process on one device, their hops an in-process rotation
  (`ops.ring_attention.drive_virtual`).

The schedule is JAX's, tick by tick: at tick t stage 0 injects
microbatch t (t < M), every stage runs `stage_fn` on its state, the last
stage emits microbatch t - (F - 1), and the state hops one stage on. No
bubble tick is skipped, so kernel launches and wire bytes are JAX's. The
last stage's outputs are then broadcast to every pp rank.

The backward is a schedule too, the forward's reversed: each tick's
stage function is differentiated on its own (`torch.autograd.grad` on the
graph the forward kept for that tick), and its input's cotangent hops one
stage back. It is not left to autograd across hops: autograd skips a node
whose output cannot reach the loss (a bubble tick's hop on some stages, the
states stage 0 overwrites with a new microbatch), and a hop that one rank
skips while its neighbour makes it would hang both. Here every rank makes
every hop, zeros included, as JAX's transposed scan does.

The gradient is that of ONE loss, as in JAX, where the replicated loss's
`psum` transposes to a sum over pp: the output broadcast's backward takes
the last stage's own cotangent and sends nothing (every pp rank holds the
same one), and the input's cotangent, which arises on stage 0 only, is
summed over pp so that every rank's embedding sees it. Inside a stage, dp,
fsdp, sp, ep and tp stay DTensor's: the stage's params and activations are
DTensors on the sub-mesh without pp, made with `DTensor.from_local` from
this rank's pp shard; each param's gradient is summed over the ticks and
reduced to its placement once. With sp the activation keeps its sequence
split, each tick's attention runs ring (or Ulysses) attention over the
sub-mesh's sp group, and every sp rank of a stage runs the same ticks in
the same order, so the ring's hops pair up inside each tick's forward and
backward.

The accounted "pipeline.ppermute" bytes are the JAX package's count, of
the whole activation: with dp or sp each pp group's hops carry its shard,
and the groups' shards make the whole up.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch.ops.ring_attention import drive, drive_virtual
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.util.collective.hierarchy import (account_collective,
                                                     ring_perm)
from ray_tpu_torch.utils.platform import default_device
from ray_tpu_torch.utils.tree import leaves as _leaves
from ray_tpu_torch.utils.tree import tree_map as _tree_map


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _split_layers(a, n_stages: int):
    """[L, ...] -> [n_stages, L/n_stages, ...]. A DTensor whose layer dim
    is split over `pp` in n_stages shards (the rule "layers": "pp") is
    rebuilt from its local [L/F, ...] shard, so DTensor never has to
    propagate a view of a sharded dim."""
    from torch.distributed.tensor import DTensor, Shard

    L = a.shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")
    if not isinstance(a, DTensor):
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    names = mesh_lib.mesh_axes(a.device_mesh)
    pp = names.index("pp") if "pp" in names else None
    if pp is None or a.placements[pp] != Shard(0) or \
            a.device_mesh.size(pp) != n_stages:
        raise ValueError(f"a DTensor's layer dim stacks into stages only "
                         f"when it is split over pp in {n_stages}, got "
                         f"{a.placements} over {names}")
    placements = [Shard(p.dim % a.ndim + 1)
                  if isinstance(p, Shard) and i != pp else p
                  for i, p in enumerate(a.placements)]
    shape = (n_stages, L // n_stages, *a.shape[1:])
    return DTensor.from_local(a.to_local().unsqueeze(0), a.device_mesh,
                              placements, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def stack_stages(block_params: Any, n_stages: int) -> Any:
    """[L, ...]-stacked block params -> [n_stages, L/n_stages, ...]."""
    return _tree_map(lambda a: _split_layers(a, n_stages), block_params)


def make_stage_fn(block_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                  remat=True) -> Callable:
    """Lift a single-block fn (x, block_params) -> x into a stage fn that
    runs its stage's [L/F, ...] blocks in order. `remat`: False or None
    keeps every activation; True recomputes each block ("full"); a policy
    name of the models' remat ("full", "dots", "dots_all") keeps what it
    names."""
    from ray_tpu_torch.models.gpt2 import _layers, _remat

    policy = "full" if remat is True else (remat or None)

    def stage_fn(stage_p, x):
        body = _remat(block_fn, policy)
        for bp in _layers(stage_p):
            x = body(x, bp)
        return x

    return stage_fn


# ---------------------------------------------------------------------------
# One stage's schedule
# ---------------------------------------------------------------------------

class _Stage:
    """One stage of the pipeline: its params as leaves that require grad
    (on the sub-mesh without pp, or plain), the microbatches it injects
    (stage 0), and what its forward keeps for the backward: each tick's
    input leaf and output."""

    def __init__(self, index: int, n_stages: int, n_micro: int, stage_fn,
                 treedef, param_locals: list, grad: bool, sub=None,
                 rules=None, placements=None):
        self.index, self.F, self.M = index, n_stages, n_micro
        self.grad = grad                 # keep each tick's graph
        self.stage_fn, self.sub, self.rules = stage_fn, sub, rules
        # on the sub-mesh: the placements of activations and of each param
        self.placements = placements or {
            "x": None, "params": [None] * len(param_locals)}
        self.treedef = treedef
        self.leaves = [self._wrap(p.detach(), pl).requires_grad_()
                       for p, pl in zip(param_locals,
                                        self.placements["params"])]
        self.ticks: list = []

    def _wrap(self, t: torch.Tensor, placements):
        """A local tensor as a DTensor on the stage's sub-mesh."""
        if self.sub is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.sub, placements, run_check=False)

    def _run(self, a: torch.Tensor) -> torch.Tensor:
        """stage_fn on the local state `a`, with the graph kept; returns the
        local output."""
        from torch.distributed.tensor import DTensor

        it = iter(self.leaves)
        params = _tree_map(lambda _: next(it), self.treedef)
        with torch.set_grad_enabled(self.grad), \
                mesh_lib.use_mesh(self.sub, self.rules):
            out = self.stage_fn(params, self._wrap(a, self.placements["x"]))
            if isinstance(out, DTensor):
                want = tuple(self.placements["x"])
                if tuple(out.placements) != want:
                    out = out.redistribute(self.sub, want)
                out = out.to_local()
        return out

    def forward(self, xs: List[torch.Tensor], like: torch.Tensor):
        """The stage's forward (a generator): yields its output every tick
        and receives the previous stage's; returns its emitted outputs (M
        of them on the last stage, None elsewhere)."""
        F, M, s = self.F, self.M, self.index
        outs = [None] * M if s == F - 1 else None
        state = torch.zeros_like(like)
        for t in range(M + F - 1):
            src = xs[t] if s == 0 and t < M else state
            a = src.detach().requires_grad_(self.grad)
            out = self._run(a)
            if self.grad:
                self.ticks.append((a, out))
            if outs is not None and t >= F - 1:
                outs[t - (F - 1)] = out.detach()
            state = yield out.detach()
        return outs

    def backward(self, d_outs: Optional[List[torch.Tensor]]):
        """The stage's backward (a generator), ticks in reverse: yields the
        cotangent of its input at each tick but the first to the previous
        stage and receives the next stage's (the cotangent of its own output
        a tick earlier); returns (the cotangents of the microbatches it
        injected, or None; the params' local gradients)."""
        F, M, s = self.F, self.M, self.index
        d_xs = [None] * M if s == 0 else None
        grads = [None] * len(self.leaves)
        g = torch.zeros_like(self.ticks[-1][1])  # the last hop is unused
        for t in reversed(range(M + F - 1)):
            a, out = self.ticks.pop()
            if s == F - 1 and t >= F - 1:
                g = g + d_outs[t - (F - 1)]
            with torch.enable_grad(), mesh_lib.use_mesh(self.sub,
                                                        self.rules):
                da, *dp = torch.autograd.grad(out, [a, *self.leaves], g,
                                              allow_unused=True)
            for i, d in enumerate(dp):
                if d is not None:
                    grads[i] = d if grads[i] is None else grads[i] + d
            if da is None:
                da = torch.zeros_like(a)
            if d_xs is not None and t < M:
                # the state received at this tick was overwritten
                d_xs[t], da = da, torch.zeros_like(da)
            if t:
                g = yield da
        return d_xs, [self._local_grad(d, p, pl) for d, p, pl in zip(
            grads, self.leaves, self.placements["params"])]

    def _local_grad(self, d, leaf, placements) -> torch.Tensor:
        """A param's gradient summed over the ticks, reduced to the param's
        placement on the sub-mesh and taken local."""
        from torch.distributed.tensor import DTensor

        if d is None:
            d = torch.zeros_like(leaf)
        if isinstance(d, DTensor):
            if tuple(d.placements) != tuple(placements):
                d = d.redistribute(self.sub, placements)
            d = d.to_local()
        return d


def _microbatches(x: torch.Tensor, M: int) -> List[torch.Tensor]:
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_microbatches {M}")
    return list(x.chunk(M, dim=0))


# ---------------------------------------------------------------------------
# Runners: where the stages run
# ---------------------------------------------------------------------------

class _Virtual:
    """The F stages in this process, hops rotated in memory."""

    def __init__(self, stage_fn, treedef, F, M):
        self.stage_fn, self.treedef, self.F, self.M = stage_fn, treedef, F, M

    def forward(self, x, params, grad: bool):
        self.stages = [_Stage(s, self.F, self.M, self.stage_fn, self.treedef,
                              [p[s] for p in params], grad)
                       for s in range(self.F)]
        xs = _microbatches(x, self.M)
        outs = drive_virtual([st.forward(xs, xs[0]) for st in self.stages])
        return torch.cat(outs[-1], dim=0)

    def backward(self, g):
        d_outs = list(g.chunk(self.M, dim=0))
        # reversed, so stage s receives from stage s + 1
        res = drive_virtual([st.backward(d_outs if s == self.F - 1 else None)
                             for s, st in enumerate(self.stages)][::-1])[::-1]
        dx = torch.cat(res[0][0], dim=0)
        dparams = [torch.stack(ds) for ds in zip(*(r[1] for r in res))]
        del self.stages
        return dx, dparams


class _Distributed:
    """This rank's stage of a pp group; the hops over the group's Comm."""

    def __init__(self, stage_fn, treedef, F, M, mesh, axis, rules,
                 placements):
        from ray_tpu_torch.util.collective._comm import Comm

        self.comm = Comm.registered(mesh.get_group(axis))
        names = [n for n in mesh_lib.mesh_axes(mesh) if n != axis]
        self.sub = mesh[tuple(names)] if names else None
        self.stage_fn, self.treedef, self.F, self.M = stage_fn, treedef, F, M
        self.rules, self.placements = rules, placements

    def _exchange(self, step: int) -> Callable:
        """One hop `step` stages on along the ring (+1 forward, -1 back)."""
        comm = self.comm
        nxt, prv = dict(ring_perm(self.F))[comm.rank], (comm.rank - 1) % self.F
        dst, src = (nxt, prv) if step > 0 else (prv, nxt)

        def exchange(t: torch.Tensor) -> torch.Tensor:
            return comm.exchange(t, dst, torch.empty_like(t), src)
        return exchange

    def forward(self, x, params, grad: bool):
        self.stage = _Stage(self.comm.rank, self.F, self.M, self.stage_fn,
                            self.treedef, params, grad, self.sub, self.rules,
                            self.placements)
        xs = _microbatches(x, self.M)
        outs = drive(self.stage.forward(xs, xs[0]), self._exchange(1))
        y = (torch.cat(outs, dim=0) if outs is not None
             else torch.empty_like(x))
        return self.comm.broadcast(y, self.F - 1)

    def backward(self, g):
        last = self.comm.rank == self.F - 1
        d_xs, dparams = drive(self.stage.backward(
            list(g.chunk(self.M, dim=0)) if last else None),
            self._exchange(-1))
        dx = torch.cat(d_xs, dim=0) if d_xs is not None else \
            torch.zeros_like(g)
        self.comm.all_reduce(dx)    # the psum of the input's cotangent
        del self.stage
        return dx, dparams


class _Pipeline(torch.autograd.Function):
    """The pipeline as one autograd node: inputs the activation and the
    params' leaves (local tensors), output the replicated activation; its
    backward runs the runner's backward schedules. `grad`: whether the
    forward keeps each tick's graph (False when nothing needs a
    gradient)."""

    @staticmethod
    def forward(ctx, runner, grad, x, *params):
        ctx.runner = runner
        return runner.forward(x, list(params), grad)

    @staticmethod
    def backward(ctx, g):
        dx, dparams = ctx.runner.backward(g.contiguous())
        return (None, None, dx, *dparams)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def _depth(stage_params, mesh, axis: str) -> int:
    if mesh is not None:
        return mesh_lib.axis_size(mesh, axis)
    sizes = {p.shape[0] for p in _leaves(stage_params)}
    if len(sizes) != 1:
        raise ValueError(f"stage params disagree on the stage count: {sizes}")
    return sizes.pop()


def _sub_placements(placements, pp: int, drop_dim: bool) -> list:
    """A full-mesh placement without its pp entry; with drop_dim, shards
    renumbered for a tensor that lost its leading (stage) dim."""
    from torch.distributed.tensor import Shard

    out = []
    for i, p in enumerate(placements):
        if i == pp:
            continue
        if drop_dim and isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a stage param's stage dim is split over "
                                 "an axis other than pp")
            p = Shard(p.dim - 1)
        out.append(p)
    return out


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   n_microbatches: int, mesh=None,
                   axis: str = "pp") -> torch.Tensor:
    """Run `stage_fn` as an F-deep pipeline over microbatches of `x`.

    stage_params: a tree whose every leaf has leading dim F (`stack_stages`
    makes it). On a mesh (`mesh`, or the current one) with `axis` of F > 1
    ranks, the leaves are DTensors split over `axis` on that dim and this
    rank runs its stage; with no mesh, F is the leaves' leading dim and all
    F stages run in this process. x: [B, ...] (a DTensor on the mesh,
    replicated over `axis`); B % n_microbatches == 0.
    stage_fn(params_of_one_stage, x_mb) -> x_mb."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = mesh or mesh_lib.current_mesh()
    F = _depth(stage_params, mesh, axis)
    if F == 1:
        return stage_fn(_tree_map(lambda a: a[0], stage_params), x)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    if M < F:
        raise ValueError(f"n_microbatches {M} < pipeline depth {F}: "
                         "bubble would dominate; use M >= pp")
    # each of the M + F - 1 ticks, every stage forwards one microbatch
    account_collective("pipeline.ppermute",
                       (M + F - 1) * F * (x.numel() * x.element_size() // M),
                       x.dtype, hop="intra")
    params = _leaves(stage_params)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *params])
    if mesh is None:
        runner = _Virtual(stage_fn, stage_params, F, M)
        return _Pipeline.apply(runner, grad, x, *params)

    names = mesh_lib.mesh_axes(mesh)
    pp = names.index(axis)
    if not isinstance(x, DTensor):
        raise TypeError(f"pipeline_apply on a mesh with {axis} > 1 takes a "
                        f"DTensor activation, got {type(x).__name__}")
    if x.placements[pp] != Replicate():
        raise ValueError(f"the activation must be replicated over {axis}, "
                         f"got {x.placements}")
    for p in params:
        if not isinstance(p, DTensor) or p.device_mesh != mesh:
            raise TypeError("stage params on a mesh are DTensors on it "
                            "(stack_stages of params placed by param_specs "
                            "with the rule 'layers': 'pp')")
    placements = {"x": _sub_placements(x.placements, pp, False),
                  "params": [_sub_placements(p.placements, pp, True)
                             for p in params]}
    runner = _Distributed(stage_fn, stage_params, F, M, mesh, axis,
                          mesh_lib.current_rules(), placements)
    local = _Pipeline.apply(runner, grad, x.to_local(),
                            *(p.to_local()[0] for p in params))
    return DTensor.from_local(local, mesh, x.placements, shape=x.shape,
                              stride=x.stride())


# ---------------------------------------------------------------------------
# A reference stage (tests, benchmarks)
# ---------------------------------------------------------------------------

def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, the default last-stage loss."""
    return torch.mean((pred - target) ** 2)


def mlp_stage_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Reference stage for tests and benchmarks: one tanh MLP layer."""
    return torch.tanh(x @ params["w"] + params["b"])


def init_mlp_stage(generator: torch.Generator, d_in: int, d_out: int,
                   scale: float = 0.3, device=None) -> dict:
    """{"w": N(0, scale^2) [d_in, d_out], "b": zeros [d_out]} from
    `generator` (a CPU generator), on `device`."""
    device = default_device(device)
    return {"w": (torch.randn((d_in, d_out), generator=generator)
                  * scale).to(device),
            "b": torch.zeros((d_out,), device=device)}


__all__ = ["stack_stages", "make_stage_fn", "pipeline_apply", "mse_loss",
           "mlp_stage_fn", "init_mlp_stage"]
