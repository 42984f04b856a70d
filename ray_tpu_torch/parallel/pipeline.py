"""Pipeline parallelism: the GPipe microbatch pipeline over the `pp` mesh
axis, and the host-level 1F1B pipeline of stage actors joined by compiled
rings (counterpart of `ray_tpu/parallel/pipeline.py`).

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

The host-level pipeline (`ChannelPipelineStage`, `CompiledPipeline`,
`eager_pipeline_step`) is the JAX package's second one: each stage a
long-lived actor holding its params on its own device, microbatches and
their gradients handed between stages through pre-negotiated shm rings
(`ray_tpu_torch.dag.channel`, a remote reader across nodes) on the 1F1B
schedule, or, as the baseline, through ordinary actor calls in GPipe
order. With `tensor_transport="device"` an activation stays in its
stage's device store and only a descriptor rides the ring.
"""

from __future__ import annotations

import time
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


# ---------------------------------------------------------------------------
# The host-level 1F1B pipeline: stage actors joined by compiled-DAG rings
# ---------------------------------------------------------------------------

def _grad_leaves(params: Any) -> tuple:
    """(params with every floating leaf a fresh autograd leaf, those
    leaves in `leaves` order)."""
    out = _tree_map(lambda p: (p.detach().requires_grad_(True)
                               if p.is_floating_point() else p), params)
    return out, [p for p in _leaves(out) if p.requires_grad]


def _grads_tree(params: Any, grads: list) -> Any:
    """The gradient leaves of `_grad_leaves` back in the tree's shape (a
    non-floating leaf, or one the output does not reach, gets zeros)."""
    it = iter(grads)

    def grad_of(p):
        g = next(it) if p.is_floating_point() else None
        return torch.zeros_like(p) if g is None else g

    return _tree_map(grad_of, params)


def _host(value) -> torch.Tensor:
    """A CPU tensor of `value` (a tensor, a numpy array or a list)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    import numpy as np

    arr = np.asarray(value)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class ChannelPipelineStage:
    """One pipeline stage as a long-lived actor (counterpart of the JAX
    package's `ChannelPipelineStage`): holds its params on `device`, a
    forward under `no_grad` that keeps the stage's input, a backward that
    runs `stage_fn` again under autograd and takes the gradients of the
    params (and of the input when it is floating), and on the last stage
    the loss and its gradients. Wrap with `ray_tpu_torch.remote` (or use
    `CompiledPipeline.build_stages`). Two drive modes:

    - eager: the driver calls `fwd_eager`/`bwd_eager` per microbatch
      (GPipe over ordinary actor RPCs — the baseline the compiled mode
      is measured against);
    - compiled: `pp_stage_loop(cfg)` attaches pre-negotiated channels
      and runs the 1F1B schedule until the input channel closes.

    The backward's recompute is what JAX's jitted `jax.vjp` inside its
    `_bwd` does: a stage's forward runs twice a microbatch, once under
    `no_grad` and once under autograd (so a flash-attention stage
    launches K1 twice and K2 and K3 once, the last stage K1, K2 and K3
    once). A stage whose input is not floating (token ids into stage 0)
    returns no input gradient, as JAX's float0 cotangent carries none.
    Activations leave a stage as CPU tensors on a host edge and as device
    objects on a device edge; each stage moves what it receives to its own
    device.
    """

    def __init__(self, stage_fn: Callable, params: Any, *,
                 position: int, n_stages: int, lr: float = 0.05,
                 loss_fn: Optional[Callable] = None, device=None):
        self.position = int(position)
        self.n_stages = int(n_stages)
        self.is_first = self.position == 0
        self.is_last = self.position == self.n_stages - 1
        self.lr = float(lr)
        self.device = default_device(device)
        self.params = _tree_map(lambda p: _host(p).to(self.device), params)
        self._stage_fn = stage_fn
        self._loss_fn = (loss_fn or mse_loss) if self.is_last else None
        self._acc = None
        self._stash: dict = {}
        self._losses: list = []
        self.steps_done = 0
        self._dev_refs: list = []
        # eager calls arrive in submission order but may EXECUTE
        # concurrently (the actor leaves executor room for control
        # calls); the lock serializes them back into schedule order
        import threading

        self._eager_lock = threading.Lock()

    # ------------------------------------------------------------ common
    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._stage_fn(self.params, x)

    def _autograd(self, x: torch.Tensor, head: Callable, g=None) -> tuple:
        """`head(params, x)` under autograd from this stage's params and
        input: (its value, (param grads, input grad or None)); `g` is the
        output's cotangent (None for a scalar loss)."""
        with torch.enable_grad():
            params, ps = _grad_leaves(self.params)
            xs = [x.detach().requires_grad_(True)] \
                if x.is_floating_point() else []
            out = head(params, xs[0] if xs else x)
            grads = torch.autograd.grad(out, ps + xs, grad_outputs=g,
                                        allow_unused=True)
        return out.detach(), (_grads_tree(self.params,
                                          list(grads[:len(ps)])),
                              grads[len(ps)] if xs else None)

    def _bwd(self, x: torch.Tensor, g: torch.Tensor) -> tuple:
        """(param grads, input grad or None) of the stage at input `x`
        for the output cotangent `g`."""
        return self._autograd(x, self._stage_fn, g)[1]

    def _lossgrad(self, x: torch.Tensor, y: torch.Tensor) -> tuple:
        """(loss, (param grads, input grad or None)) of the last stage."""
        return self._autograd(
            x, lambda p, h: self._loss_fn(self._stage_fn(p, h), y))

    def _accumulate(self, dp) -> None:
        if self._acc is None:
            self._acc = dp
            return
        parts = iter(_leaves(dp))
        self._acc = _tree_map(lambda a: a + next(parts), self._acc)

    def apply_grads(self, n_microbatches: int, _after=None) -> bool:
        if self._acc is not None:
            step = self.lr / n_microbatches
            acc = iter(_leaves(self._acc))
            self.params = _tree_map(lambda p: p - step * next(acc),
                                    self.params)
            self._acc = None
        self.steps_done += 1
        return True

    def get_params(self):
        """The params as numpy arrays (a bf16 leaf as float32)."""
        return _tree_map(lambda p: (p.float() if p.dtype == torch.bfloat16
                                    else p).detach().cpu().numpy(),
                         self.params)

    def _in(self, value) -> torch.Tensor:
        """`value` (a tensor or a numpy array) on this stage's device."""
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return _host(value).to(self.device)

    # ------------------------------------------------- eager (RPC) drive
    # `_after` is a sequencing-only dependency: the driver threads each
    # stage's previous op ref through it so ops run in schedule order
    # even when the actor executes calls concurrently (lock wakeup order
    # is not FIFO; argument resolution is).
    def fwd_eager(self, mb: int, x, y=None, _after=None):
        with self._eager_lock:
            x = self._in(x)
            if self.is_last:
                loss, (dp, dx) = self._lossgrad(x, self._in(y))
                self._accumulate(dp)
                self._losses.append(float(loss))
                self._stash[mb] = dx
                return None
            act = self._fwd(x)
            self._stash[mb] = x
            return act.detach().cpu()

    def bwd_eager(self, mb: int, g=None, _after=None):
        with self._eager_lock:
            if self.is_last:
                dx = self._stash.pop(mb)
                return None if dx is None else dx.detach().cpu()
            dp, dx = self._bwd(self._stash.pop(mb), self._in(g))
            self._accumulate(dp)
            return None if self.is_first or dx is None else dx.detach().cpu()

    def pop_mean_loss(self, _after=None) -> float:
        losses, self._losses = self._losses, []
        return float(sum(losses) / max(1, len(losses)))

    # ------------------------------------------- compiled (channel) drive
    def _wrap(self, t: torch.Tensor, transport, ring: int):
        if transport == "device":
            from ray_tpu_torch.core.api import _global_client
            from ray_tpu_torch.dag.runtime import DEVICE_DESC

            oref = _global_client().put_device(t.detach())
            # hold enough generations to cover the ring depth plus the
            # value a reader may still be fetching
            self._dev_refs.append(oref)
            while len(self._dev_refs) > 2 * ring + 2:
                self._dev_refs.pop(0)
            return {DEVICE_DESC: oref.binary()}
        return t.detach().cpu()

    def _schedule(self, M: int) -> list:
        """1F1B op order for this stage: warmup forwards, steady
        (forward, backward) pairs, cooldown backwards."""
        W = min(self.n_stages - 1 - self.position, M)
        ops = [("F", k) for k in range(W)]
        for k in range(M - W):
            ops.append(("F", W + k))
            ops.append(("B", k))
        ops.extend(("B", k) for k in range(M - W, M))
        return ops

    def _stage_span(self, carrier, t0: float):
        """Record this stage's forward span for a sampled microbatch
        (backdated over the compute it just ran) and return the child
        carrier the NEXT stage parents to — the per-hop link in the
        compiled 1F1B submit→stage→…→stage span chain. None when the
        microbatch is untraced."""
        if carrier is None:
            return None
        try:
            from ray_tpu_torch.util import tracing

            dur = time.perf_counter() - t0
            with tracing.start_span(
                    f"pp.stage{self.position}.fwd", carrier=carrier,
                    attributes={"ray_tpu.op": "pp_stage",
                                "position": self.position}) as sp:
                if sp is None:
                    return None
                sp.start_ts = time.time() - dur
                return {"traceparent": sp.traceparent()}
        except Exception:
            return None

    def _publish_ring_telemetry(self, key: str, *endpoints) -> None:
        """Snapshot this stage's LOCAL ring handles (remote-reader edges
        are sampled by their hosting process) into the hot-path
        observatory, labelled by edge role."""
        from ray_tpu_torch.dag.channel import Channel, publish_ring_stats

        snaps = {}
        for label, ep in zip(("in", "out", "gin", "gout"), endpoints):
            if isinstance(ep, Channel):
                try:
                    snaps[label] = ep.snapshot()
                except Exception:
                    pass
        if snaps:
            publish_ring_stats("pipeline", f"{key}/stage{self.position}",
                               snaps)

    def pp_stage_loop(self, cfg: dict) -> dict:
        """Attach this stage's pre-negotiated channel edges and run 1F1B
        steps until the upstream channel closes (driver teardown). A step
        that raises (a device edge that cannot be fetched, a kernel that
        fails to launch) closes this stage's output rings and raises."""
        from ray_tpu_torch.dag.channel import (Channel, ChannelClosedError,
                                               RemoteChannelReader)
        from ray_tpu_torch.dag.runtime import materialize_channel_value

        def endpoint(ref):
            if ref is None:
                return None
            kind, val = ref
            if kind == "chan":
                return Channel.attach(val)
            return RemoteChannelReader(*val)

        in_r = endpoint(cfg["in"])
        out_w = endpoint(cfg.get("out"))
        gin_r = endpoint(cfg.get("gin"))
        gout_w = endpoint(cfg.get("gout"))
        loss_w = endpoint(cfg.get("loss"))
        M = int(cfg["M"])
        ring = int(cfg.get("ring", 1))
        transport = cfg.get("transport")
        key = str(cfg.get("key", "pp"))
        ops = self._schedule(M)
        steps = 0
        last_telem = 0.0
        try:
            from ray_tpu_torch.core import config as _cfg

            telem_interval = float(_cfg.get("ring_telemetry_interval_s"))
        except Exception:
            telem_interval = 0.0
        try:
            while True:
                losses = []
                for op, k in ops:
                    if op == "F":
                        # a sampled microbatch carries a W3C carrier as a
                        # third tuple element (CompiledPipeline.step /
                        # the upstream stage's _stage_span)
                        item = in_r.read()
                        carrier = item[2] if len(item) > 2 else None
                        x = self._in(materialize_channel_value(item[0]))
                        y = item[1]
                        t0 = time.perf_counter()
                        if self.is_last:
                            loss, (dp, dx) = self._lossgrad(x, self._in(y))
                            self._accumulate(dp)
                            losses.append(loss)
                            if gout_w is not None:
                                gout_w.write(self._wrap(dx, transport, ring))
                            self._stage_span(carrier, t0)
                        else:
                            act = self._fwd(x)
                            self._stash[k] = x
                            child = self._stage_span(carrier, t0)
                            payload = (self._wrap(act, transport, ring), y)
                            if child is not None:
                                payload = payload + (child,)
                            out_w.write(payload)
                    elif not self.is_last:
                        g = self._in(materialize_channel_value(gin_r.read()))
                        dp, dx = self._bwd(self._stash.pop(k), g)
                        self._accumulate(dp)
                        if gout_w is not None:
                            gout_w.write(self._wrap(dx, transport, ring))
                self.apply_grads(M)
                if loss_w is not None:
                    loss_w.write(float(sum(float(v) for v in losses)
                                       / max(1, len(losses))))
                steps += 1
                if telem_interval > 0 \
                        and time.monotonic() - last_telem > telem_interval:
                    last_telem = time.monotonic()
                    self._publish_ring_telemetry(key, in_r, out_w,
                                                 gin_r, gout_w)
        except ChannelClosedError:
            pass
        finally:
            # propagate shutdown downstream so every stage's loop exits
            for ch in (out_w, gout_w, loss_w):
                if ch is not None:
                    try:
                        ch.close()
                    except Exception:
                        pass
            self._stash.clear()
            self._dev_refs.clear()
        return {"steps": steps, "position": self.position}


class CompiledPipeline:
    """Driver handle for a channel-driven 1F1B pipeline over stage
    actors. `start()` negotiates every channel once (the only
    control-plane work); `step(x, y)` streams microbatches through the
    input ring and blocks on the loss ring — zero per-step RPCs when the
    stages are co-located, RemoteChannelReader edges otherwise. Its rings
    are named ``rtpt_pp_<tag>_*``; `close` unlinks every one."""

    def __init__(self, stage_actors, *, n_microbatches: int,
                 max_inflight: Optional[int] = None,
                 channel_capacity: int = 4 << 20,
                 tensor_transport: Optional[str] = None,
                 step_timeout: float = 120.0):
        if not stage_actors:
            raise ValueError("need at least one stage actor")
        self.stages = list(stage_actors)
        self.M = int(n_microbatches)
        F = len(self.stages)
        self.max_inflight = int(max_inflight or max(2, min(self.M, F + 1)))
        self.capacity = channel_capacity
        self.transport = tensor_transport
        self.step_timeout = step_timeout
        self._started = False
        self._closed = False
        self._loop_refs = []
        self._remote_created = []
        self.names: dict = {}
        self.key = "pp"               # replaced by the start() tag
        self._trace_seq = 0
        self._last_telem = 0.0

    @staticmethod
    def build_stages(stage_fns, params_list, *, lr: float = 0.05,
                     loss_fn: Optional[Callable] = None,
                     actor_options: Optional[list] = None, device=None):
        """Create one ChannelPipelineStage actor per (stage_fn, params),
        each holding its params on `device` (None: the card its process
        sees). `actor_options[i]` (e.g. {"num_gpus": 1}) pins placement."""
        import ray_tpu_torch

        F = len(params_list)
        fns = (stage_fns if isinstance(stage_fns, (list, tuple))
               else [stage_fns] * F)
        actors = []
        for i, (fn, p) in enumerate(zip(fns, params_list)):
            opts = dict((actor_options[i] if actor_options else {}) or {})
            # the compiled stage loop occupies one executor thread for its
            # lifetime; leave room for control calls (get_params, eager)
            opts.setdefault("max_concurrency", 4)
            cls = ray_tpu_torch.remote(**opts)(ChannelPipelineStage)
            actors.append(cls.remote(
                fn, p, position=i, n_stages=F, lr=lr,
                loss_fn=loss_fn if i == F - 1 else None, device=device))
        return actors

    # ------------------------------------------------------------ bring-up
    def start(self) -> None:
        import os as _os

        from ray_tpu_torch.core.api import _global_client
        from ray_tpu_torch.dag.channel import Channel, RemoteChannelReader

        client = _global_client()
        my_node = client.node_id.binary()
        my_addr = ("127.0.0.1", client.direct_port)
        F = len(self.stages)

        addr, node = [], []
        for s in self.stages:
            reply = client.head_request("get_actor_address",
                                        actor_id=s._actor_id.binary())
            if reply["state"] == "DEAD":
                raise RuntimeError("cannot compile over dead stage actor")
            node.append(reply.get("node_id") or my_node)
            addr.append(tuple(reply["address"]))

        tag = _os.urandom(4).hex()
        self.key = f"pp_{tag}"
        names = {"in": f"rtpt_pp_{tag}_in",
                 "loss": f"rtpt_pp_{tag}_loss"}
        for i in range(F - 1):
            names[f"act{i}"] = f"rtpt_pp_{tag}_a{i}"      # stage i -> i+1
            names[f"grad{i + 1}"] = f"rtpt_pp_{tag}_g{i + 1}"  # i+1 -> i
        self.names = names

        # two-phase bring-up: every channel is created in its WRITER's
        # process before any stage loop starts
        self._input = Channel(name=names["in"], capacity=self.capacity,
                              num_readers=1, num_slots=self.max_inflight)

        def create_at(stage_idx: int, name: str) -> None:
            client.direct_request(
                addr[stage_idx], "dag_chan_create", name=name,
                capacity=self.capacity, num_readers=1,
                num_slots=self.max_inflight)
            self._remote_created.append((addr[stage_idx], name))

        for i in range(F - 1):
            create_at(i, names[f"act{i}"])
            create_at(i + 1, names[f"grad{i + 1}"])
        create_at(F - 1, names["loss"])

        def ref_for(name: str, writer_idx: Optional[int],
                    consumer_node: bytes):
            w_node = my_node if writer_idx is None else node[writer_idx]
            w_addr = my_addr if writer_idx is None else addr[writer_idx]
            if w_node == consumer_node:
                return ("chan", name)
            return ("rchan", (name, w_addr))

        for i, s in enumerate(self.stages):
            cfg = {"M": self.M, "ring": self.max_inflight,
                   "transport": self.transport, "key": self.key,
                   "in": (ref_for(names["in"], None, node[i]) if i == 0
                          else ref_for(names[f"act{i - 1}"], i - 1,
                                       node[i])),
                   "out": (ref_for(names[f"act{i}"], i, node[i])
                           if i < F - 1 else None),
                   "gin": (ref_for(names[f"grad{i + 1}"], i + 1, node[i])
                           if i < F - 1 else None),
                   "gout": (ref_for(names[f"grad{i}"], i, node[i])
                            if i > 0 else None),
                   "loss": (ref_for(names["loss"], F - 1, node[i])
                            if i == F - 1 else None)}
            self._loop_refs.append(s.pp_stage_loop.remote(cfg))

        if node[F - 1] == my_node:
            self._loss_r = Channel.attach(names["loss"])
        else:
            self._loss_r = RemoteChannelReader(names["loss"], addr[F - 1])
        self._started = True

    # ------------------------------------------------------------- control
    def _maybe_trace_step(self):
        """1-in-N sampled step tracing (`tracing_compiled_sample_n`, the
        same knob as the serve chain): the returned W3C carrier rides
        microbatch 0's ring tuple, so a sampled step yields the full
        submit→stage→…→stage span chain in the chrome timeline with
        zero extra RPCs. None for unsampled/untraced steps."""
        try:
            from ray_tpu_torch.core import config as _cfg
            from ray_tpu_torch.util import tracing

            n = int(_cfg.get("tracing_compiled_sample_n"))
            if n <= 0 or not tracing.is_recording():
                return None
            seq = self._trace_seq
            self._trace_seq = seq + 1
            if seq % n:
                return None
            with tracing.start_span(
                    "pp.step.submit",
                    attributes={"ray_tpu.op": "pp_submit",
                                "pipeline": self.key,
                                "microbatches": self.M}) as sp:
                if sp is None:
                    return None
                return {"traceparent": sp.traceparent()}
        except Exception:
            return None

    def _telemetry_tick(self) -> None:
        """Time-gated driver-side ring snapshots (input + loss rings,
        when local) into the hot-path observatory."""
        try:
            from ray_tpu_torch.core import config as _cfg

            interval = float(_cfg.get("ring_telemetry_interval_s"))
        except Exception:
            return
        if interval <= 0 or time.monotonic() - self._last_telem < interval:
            return
        self._last_telem = time.monotonic()
        from ray_tpu_torch.dag.channel import Channel, publish_ring_stats

        snaps = {}
        try:
            snaps["in"] = self._input.snapshot()
        except Exception:
            pass
        if isinstance(getattr(self, "_loss_r", None), Channel):
            try:
                snaps["loss"] = self._loss_r.snapshot()
            except Exception:
                pass
        if snaps:
            publish_ring_stats("pipeline", self.key, snaps)

    def step(self, x, y) -> float:
        """Stream one batch through the pipeline as M microbatches;
        returns the step's mean loss. Microbatch writes backpressure on
        the input ring, so up to max_inflight microbatches pipeline into
        the stages while earlier ones are still in flight. `x` and `y`
        (tensors or numpy arrays) travel as CPU tensors."""
        if self._closed:
            raise RuntimeError("pipeline was closed")
        if not self._started:
            self.start()
        x, y = _host(x), _host(y)
        B = x.shape[0]
        if B % self.M:
            raise ValueError(f"batch {B} not divisible by M={self.M}")
        mb = B // self.M
        carrier = self._maybe_trace_step()
        for k in range(self.M):
            payload = (x[k * mb:(k + 1) * mb], y[k * mb:(k + 1) * mb])
            if k == 0 and carrier is not None:
                payload = payload + (carrier,)
            self._input.write(payload, timeout=self.step_timeout)
        loss = float(self._loss_r.read(timeout=self.step_timeout))
        self._telemetry_tick()
        return loss

    def get_params(self, timeout: float = 60.0) -> list:
        import ray_tpu_torch

        return ray_tpu_torch.get([s.get_params.remote()
                                  for s in self.stages], timeout=timeout)

    def close(self, timeout: float = 30.0, kill_actors: bool = False) -> None:
        import ray_tpu_torch

        if self._closed or not self._started:
            self._closed = True
            if kill_actors:
                for s in self.stages:
                    try:
                        ray_tpu_torch.kill(s)
                    except Exception:
                        pass
            return
        self._closed = True
        from ray_tpu_torch.core.api import _global_client

        self._input.close(unlink=True)
        if isinstance(self._loss_r, type(self._input)):
            self._loss_r.close()
        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=timeout)
            except Exception:
                pass
        client = _global_client()
        for a, name in self._remote_created:
            try:
                client.direct_request(a, "dag_chan_close", name=name,
                                      unlink=True)
            except Exception:
                pass
        if kill_actors:
            for s in self.stages:
                try:
                    ray_tpu_torch.kill(s)
                except Exception:
                    pass


def eager_pipeline_step(stage_actors, x, y, n_microbatches: int,
                        timeout: float = 120.0) -> float:
    """GPipe over ordinary actor calls — the dynamic-dispatch baseline
    the compiled 1F1B mode is benchmarked against. Every microbatch edge
    pays actor-call submission + result resolution through the task
    plane; returns the step's mean loss."""
    import ray_tpu_torch

    stages = list(stage_actors)
    M = int(n_microbatches)
    x, y = _host(x), _host(y)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by M={M}")
    mb = B // M
    # per-actor sequencing: each stage's ops chain on its previous op so
    # the GPipe order holds even under concurrent actor executors
    last_of: dict = {}

    def call(i, method, *args):
        ref = getattr(stages[i], method).remote(*args,
                                                _after=last_of.get(i))
        last_of[i] = ref
        return ref

    # forward sweep: chain refs stage to stage (dependencies resolve in
    # the workers; the driver still pays per-call dispatch for each edge)
    for k in range(M):
        r = None
        for i in range(len(stages)):
            xk = x[k * mb:(k + 1) * mb] if i == 0 else r
            yk = y[k * mb:(k + 1) * mb] if i == len(stages) - 1 else None
            r = call(i, "fwd_eager", k, xk, yk)
    ray_tpu_torch.get(r, timeout=timeout)
    # backward sweep in reverse microbatch order
    last_done = None
    for k in reversed(range(M)):
        g = None
        for i in reversed(range(len(stages))):
            g = call(i, "bwd_eager", k, g)
        last_done = g
    if last_done is not None:
        ray_tpu_torch.get(last_done, timeout=timeout)
    loss_ref = call(len(stages) - 1, "pop_mean_loss")
    ray_tpu_torch.get([call(i, "apply_grads", M) for i in range(len(stages))],
                      timeout=timeout)
    return float(ray_tpu_torch.get(loss_ref, timeout=timeout))


__all__ = ["stack_stages", "make_stage_fn", "pipeline_apply", "mse_loss",
           "mlp_stage_fn", "init_mlp_stage", "ChannelPipelineStage",
           "CompiledPipeline", "eager_pipeline_step"]
