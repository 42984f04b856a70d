"""Training step (counterpart of `ray_tpu/train/spmd.py`).

The JAX module compiles a mesh-sharded step with `jit` and donates the state
so XLA updates the weights in place. Here the step runs eagerly and updates
params and optimizer moments IN PLACE: the `TrainState` a step returns holds
the same tensors as the one it was given, so a caller that wants the old
weights copies them first.

- `default_optimizer` is optax's ``chain(clip_by_global_norm(clip),
  adamw(warmup_cosine_decay_schedule(...)))`` written out by hand, step for
  step as optax 0.2.6 computes it (the card's host has no optax);
- `compile_train` / `compile_model_train` / `compile_gpt2_train` return a
  `CompiledTrain` with `init_fn`, the fused `step_fn` and the split
  `grad_fn` / `apply_fn` of the JAX flat path.

Several devices run one process a device, in one of two ways:
- on a `parallel.mesh.build_mesh` mesh (dp, fsdp, tp, ep), the JAX
  package's flat path: params and Adam moments are `DTensor`s placed by the
  model's `param_specs` (`state_shardings`), the batch by `batch_sharding`,
  and DTensor's sharding propagation inserts the collectives GSPMD inserts
  there, the gradient reduction included;
- on a hierarchical `DeviceMesh` (`parallel.mesh.build_hierarchical_mesh`),
  data parallel with the fused sync: each rank takes its dp rows of the
  global batch, and the step sums the gradients with the two-level
  schedule of `util.collective.hierarchy` (reduce-scatter inside a host,
  allreduce of the shard across hosts, optionally int8/fp8 with error
  feedback, all-gather back) before the optimizer runs. Composed with
  fsdp, sp, ep or tp (the JAX package's step manual over the dp pair only,
  the rest left to its partitioner), the params, the rows and the loss
  are DTensors on the mesh's other axes (`mesh.model_submesh`), as on a
  `build_mesh` mesh, and the sync runs on each rank's local gradient
  shards.
A mesh with sp shards the activations' sequence axis (the models'
`constrain(..., "seq", ...)` points; attention runs as ring or Ulysses
attention, `ops.ring_attention`). A mesh with pp trains through
`compile_pipeline_train`: the block stack runs as a GPipe pipeline
(`parallel.pipeline`), each rank holding its stage's layers; the same
program runs its stages in one process on one device when given a
`MeshConfig` of pp alone.

`save_state_sharded` and `restore_state_sharded` write and read a whole
`TrainState` in the JAX package's sharded-checkpoint format
(`train.checkpoint`), with the JAX package's leaf keys, so a state saved by
either package, at any world size and on any mesh, restores in the other.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.util.collective.hierarchy import (hier_grad_sync,
                                                     hier_phase_programs)
from ray_tpu_torch.utils.platform import default_device
from ray_tpu_torch.utils.tree import Tree, leaves as _leaves, nest
from ray_tpu_torch.utils.tree import tree_map as _tree_map


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm). On
    DTensor leaves each sum is this rank's share (a partial sum) until the
    square root, which reduces it."""
    return torch.sqrt(sum(torch.sum(g * g) for g in _leaves(tree)))


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree
    opt_state: Any


def _structure(tree: Tree):
    return ({k: _structure(v) for k, v in tree.items()}
            if isinstance(tree, dict) else None)


def state_shardings(state: TrainState, params_spec: Tree, mesh
                    ) -> TrainState:
    """Shard params by spec; shard the opt-state subtrees that mirror the
    param tree (the Adam moments, matched by tree structure, not leaf
    shape: two same-shaped params may have different specs); replicate
    everything else. Returns a TrainState of `mesh_lib.Sharding`s."""
    from torch.distributed.tensor import Replicate

    rep = mesh_lib.Sharding(mesh, (Replicate(),) * mesh.ndim)
    specs = iter(_leaves(params_spec))
    param_shardings = _tree_map(lambda _: mesh_lib.Sharding(
        mesh, mesh_lib.spec_to_placements(mesh, next(specs))), state.params)
    structure = _structure(state.params)

    def assign(node):
        if isinstance(node, dict):
            if _structure(node) == structure:
                return param_shardings
            return {k: assign(v) for k, v in node.items()}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: assign(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, (tuple, list)):
            return type(node)(assign(c) for c in node)
        return rep

    return TrainState(step=rep, params=param_shardings,
                      opt_state=assign(state.opt_state))


def shard_params(params: Tree, mesh, specs: Tree) -> Tree:
    """Full params (the same on every rank) -> DTensors placed by `specs`
    (a tree of `PartitionSpec`s matching params). `distribute_tensor`
    scatters rank 0's values."""
    from torch.distributed.tensor import distribute_tensor

    spec_leaves = _leaves(specs)
    if len(spec_leaves) != len(_leaves(params)):
        raise ValueError(f"{len(spec_leaves)} specs for "
                         f"{len(_leaves(params))} param leaves")
    it = iter(spec_leaves)
    return _tree_map(lambda p: distribute_tensor(
        p, mesh, mesh_lib.spec_to_placements(mesh, next(it))), params)


def unshard(tree: Tree) -> Tree:
    """The inverse of `shard_params`: every DTensor leaf gathered to its full
    tensor (a collective: every rank of the mesh calls it); other leaves as
    they are."""
    from torch.distributed.tensor import DTensor

    return _tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                     else t, tree)


# ---------------------------------------------------------------------------
# The default optimizer, exact to optax 0.2.6
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule (end_value 0) in float32: a linear
    ramp from init_value to peak_value over warmup_steps, then a cosine
    decay to 0 that ends at decay_steps (which includes the warmup)."""
    f32 = np.float32
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:   # optax.linear_schedule
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps)))
        return f32(peak_value) * cosine

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int          # updates applied so far (optax's ScaleByAdam count)
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2, eps,
    weight_decay))`` of optax, applied in place.

    - clip: scale every gradient by ``clip / g_norm`` (as ``g / g_norm *
      clip``) only when ``g_norm >= clip``; no epsilon, unlike
      `torch.nn.utils.clip_grad_norm_`;
    - Adam moments in the params' dtype, bias-corrected with the count
      after the increment;
    - decoupled weight decay on every leaf: the update is
      ``-lr(t) * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)`` with
      ``t`` counting from 0, so the first update has the schedule's value at
      0.
    """
    schedule: Callable[[int], np.float32]
    b1: float
    b2: float
    weight_decay: float
    clip: float
    eps: float = 1e-8

    def init(self, params: Tree) -> AdamWState:
        return AdamWState(0, _tree_map(torch.zeros_like, params),
                          _tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: AdamWState
               ) -> torch.Tensor:
        """Apply one update to `params` and `state` in place; returns the
        global norm of `grads` before clipping (on the device: no sync)."""
        f32 = np.float32
        g_norm = global_norm(grads)
        keep = g_norm < self.clip
        lr = float(self.schedule(state.count))
        state.count += 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(state.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(state.count))
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state.mu), _leaves(state.nu)):
            g = torch.where(keep, g, g / g_norm * self.clip)
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -lr)
        return g_norm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10_000,
                      b2: float = 0.95, clip: float = 1.0) -> AdamW:
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup,
                                         max(total_steps, warmup + 1))
    return AdamW(sched, b1=0.9, b2=b2, weight_decay=weight_decay, clip=clip)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledTrain:
    """A training program bound to one device (one rank's, on a mesh)."""
    device: torch.device
    init_fn: Callable[[torch.Generator], TrainState]   # generator -> state
    step_fn: Callable[..., tuple]                      # -> (state, metrics)
    # the step split in two, for a caller that averages the gradients
    # between the calls: (state, batch) -> (loss, grads) and
    # (state, grads) -> state. Under data parallel grad_fn already returns
    # the mean loss and averaged (unquantized) gradients of the global batch.
    grad_fn: Callable[[TrainState, Any], tuple]
    apply_fn: Callable[[TrainState, Any], TrainState]
    # data parallel on a hierarchical mesh (None on one device): the mesh
    # and the Topology its dp sub-axes express; the sync alone, (state,
    # batch) -> (mean loss, averaged grads) without the update
    mesh: Any = None
    topology: Any = None
    grad_quantize: Any = None
    sync_fn: Optional[Callable[[TrainState, Any], tuple]] = None
    # with grad_quantize.error_feedback the residual is step state:
    # step_fn(state, batch, ef) -> (state, metrics, ef), seeded by
    # init_ef_fn() (this rank's [per_shard] zeros)
    init_ef_fn: Optional[Callable[[], torch.Tensor]] = None
    # phase_timing=True: (state, batch) -> (state, metrics) with
    # metrics["phases"] = {compute, rs, ar, ag, apply: seconds}
    timed_step_fn: Optional[Callable[[TrainState, Any], tuple]] = None
    # on a build_mesh mesh: the batch's Sharding and the state's (a
    # TrainState of mesh.Sharding, see state_shardings)
    batch_sharding: Any = None
    state_sharding: Any = None
    # () -> the TrainState's leaves as meta tensors (shapes and dtypes, no
    # data): the template `restore_state_sharded` restores into
    abstract_state: Optional[Callable[[], TrainState]] = None


def _one_device(mesh, device) -> torch.device:
    if mesh is not None:
        devs = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
        if len(devs) != 1 or not isinstance(devs[0], (str, torch.device)):
            raise NotImplementedError(
                "training on several devices in one process is not ported: "
                "the port runs one process a device, on a "
                "parallel.mesh.build_mesh mesh (dp, fsdp, sp, tp, ep) or "
                "build_hierarchical_mesh; pp meshes train through "
                "compile_pipeline_train")
        device = device if device is not None else devs[0]
    return default_device(device)


def _model_mesh(mesh):
    """The mesh DTensor places the params and the batch on: a `build_mesh`
    mesh itself, a composed hierarchical mesh's `model_submesh`; None for
    a dp-only hierarchical mesh and off a mesh."""
    if not isinstance(mesh, DeviceMesh):
        return None
    if mesh_lib.is_hierarchical_mesh(mesh):
        return mesh_lib.model_submesh(mesh)
    return mesh


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _mesh_device(mesh, device) -> torch.device:
    return default_device(device if device is not None else (
        "cpu" if mesh.device_type == "cpu" else None))


class _Sharded:
    """The step on a `build_mesh` mesh: the global batch as DTensors (this
    rank's window of every leaf, by `batch_sharding`), the loss and its
    gradients through DTensor, each gradient brought to its param's
    placements (the reduction GSPMD inserts)."""

    def __init__(self, mesh, rules=None, pipeline: bool = False):
        if "pp" in mesh_lib.mesh_axes(mesh) and not pipeline:
            raise NotImplementedError(
                "a mesh with pp > 1 trains through compile_pipeline_train; "
                "build_mesh meshes of dp, fsdp, sp, tp and ep train here")
        self.mesh, self.rules = mesh, rules
        self.batch_sharding = mesh_lib.Sharding(
            mesh, mesh_lib.spec_to_placements(mesh, mesh_lib.P(("dp",
                                                                "fsdp"))))

    def batch(self, batch) -> dict:
        from ray_tpu_torch.util.collective.reshard import reshard

        return {k: reshard(v, self.batch_sharding) for k, v in batch.items()}

    def grads(self, loss_fn, state: TrainState, batch) -> tuple:
        """(the mean loss, replicated, as a plain scalar; grads as DTensors
        with their params' placements)."""
        from torch.distributed.tensor import Replicate

        params = _tree_map(lambda p: p.detach().requires_grad_(),
                           state.params)
        leaves = _leaves(params)
        with torch.enable_grad(), mesh_lib.use_mesh(self.mesh, self.rules):
            loss = loss_fn(params, self.batch(batch))
            loss = loss.redistribute(self.mesh,
                                     (Replicate(),) * self.mesh.ndim)
            grads = torch.autograd.grad(loss, leaves)
        grads = iter([g.redistribute(self.mesh, p.placements)
                      for g, p in zip(grads, leaves)])
        return loss.to_local().detach(), _tree_map(lambda _: next(grads),
                                                   params)


class _PhaseClock:
    """Seconds between marks: CUDA events on the card, the host clock on
    the CPU (where every op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.names, self.marks = [], []
        self.mark(None)

    def mark(self, name) -> None:
        if name is not None:
            self.names.append(name)
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            dt = [a.elapsed_time(b) / 1e3
                  for a, b in zip(self.marks, self.marks[1:])]
        else:
            dt = [b - a for a, b in zip(self.marks, self.marks[1:])]
        return dict(zip(self.names, dt))


def _rank_rows(batch, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of every leaf of the global batch: how
    P((dp_inter, dp_intra)) shards it, block rank of world."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % world:
            raise ValueError(
                f"batch[{k!r}] has {v.shape[0]} rows, which the {world} "
                f"data-parallel ranks cannot split evenly")
        per = v.shape[0] // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out


class _DataParallel:
    """This rank's share of data parallel on a hierarchical mesh: its rows
    of the global batch, the flat f32 gradient bucket and its two-level
    sync (`_fused_hier_sync` of the JAX package, eager)."""

    def __init__(self, mesh, quantize, device: torch.device):
        self.groups = mesh_lib.hier_groups(mesh)
        self.topo = self.groups.topo
        self.world = self.topo.world
        # P((dp_inter, dp_intra)) gives member (i, j) block i * intra + j
        self.rank = self.groups.inter_pos * self.topo.intra + \
            self.groups.intra_pos
        self.quantize = quantize
        self.ef = bool(quantize is not None and quantize.error_feedback)
        self.device = device
        self.n_grads = None

    def layout(self, tree=None) -> tuple:
        """(n_grads, per_shard, n_pad), sized from the first tree of params
        or grads it sees: the bucket is padded so the intra scatter tiles
        evenly and, quantized, each shard is whole chunks."""
        if self.n_grads is None:
            if tree is None:
                raise RuntimeError("the residual is sized from the params: "
                                   "call init_fn first")
            self.n_grads = sum(_local(p).numel() for p in _leaves(tree))
        per_shard = -(-self.n_grads // self.topo.intra)
        if self.quantize is not None:
            per_shard = self.quantize.padded_size(per_shard)
        return self.n_grads, per_shard, per_shard * self.topo.intra

    def bucket(self, grads) -> torch.Tensor:
        """grads (this rank's shards of DTensors) in `_leaves` order as one
        f32 vector [n_pad]."""
        n, _, n_pad = self.layout(grads)
        parts = [_local(g).reshape(-1).to(torch.float32)
                 for g in _leaves(grads)]
        if n_pad > n:
            parts.append(torch.zeros(n_pad - n, dtype=torch.float32,
                                     device=parts[0].device))
        return torch.cat(parts)

    @staticmethod
    def unbucket(vec: torch.Tensor, like) -> Tree:
        """vec's leading entries cast back to each leaf's dtype and (local)
        shape, a DTensor leaf's as a DTensor with its placements."""
        from torch.distributed.tensor import DTensor

        sizes = [_local(g).numel() for g in _leaves(like)]
        pieces = iter(vec[:sum(sizes)].split(sizes))

        def leaf(g):
            t = next(pieces).view(_local(g).shape).to(g.dtype)
            if not isinstance(g, DTensor):
                return t
            return DTensor.from_local(t, g.device_mesh, g.placements,
                                      shape=g.shape, stride=g.stride())
        return _tree_map(leaf, like)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of every rank's loss: two chained allreduces, intra
        then inter (never a flat-world group), then / world."""
        out = loss.detach().to(torch.float32).reshape(1).clone()
        self.groups.intra.all_reduce(out)
        self.groups.inter.all_reduce(out)
        return out[0] / self.world

    def generator(self, step: int) -> Optional[torch.Generator]:
        """Stochastic rounding's draws, seeded from (step, rank): the
        counterpart of ``fold_in(PRNGKey(step), rank)``."""
        if self.quantize is None or not self.quantize.stochastic_rounding:
            return None
        return torch.Generator(device=self.device).manual_seed(
            (int(step) << 32) | self.rank)

    def sync(self, grads, step: int, quantize, residual=None) -> tuple:
        """(averaged grads, new residual or None)."""
        vec = self.bucket(grads)
        gen = self.generator(step) if quantize is not None else None
        if residual is not None:
            vec, residual = hier_grad_sync(vec, self.groups, quantize,
                                           residual=residual, generator=gen)
        else:
            vec = hier_grad_sync(vec, self.groups, quantize, generator=gen)
        return self.unbucket(vec / self.world, grads), residual


def compile_train(loss_fn: Callable[[Tree, Any], torch.Tensor],
                  init_params_fn: Callable[..., Tree], mesh=None,
                  optimizer: Optional[AdamW] = None, device=None,
                  grad_quantize=None, phase_timing: bool = False,
                  params_spec: Optional[Tree] = None, rules=None,
                  pipeline: bool = False) -> CompiledTrain:
    """Build init and step functions for any model.

    loss_fn(params, batch) -> scalar; init_params_fn(generator, device=...)
    -> params. Batches are dicts of tensors or numpy arrays, moved to the
    device by the step. The step updates params and moments in place (see
    the module docstring). On a mesh every rank calls this and `init_fn`
    with the same seed, and the step takes the GLOBAL batch.

    With `mesh` a `parallel.mesh.build_mesh` mesh, `params_spec` (a tree of
    `PartitionSpec`s matching the params; `param_specs` of the model
    families) places params and moments, the batch is split over
    ``("dp", "fsdp")``, and the model's `constrain` calls read the default
    logical rules (with `rules` over them); `batch_sharding` and
    `state_sharding` say where everything lives. `pipeline=True` is
    `compile_pipeline_train`'s: the mesh may then have pp.

    With `mesh` a hierarchical `DeviceMesh` (data parallel), each rank uses
    its rows of the batch, and the fused `step_fn` averages the gradients
    with the two-level sync, optionally quantizing the inter hop
    (`grad_quantize=QuantizedAllreduce(...)`); with error feedback the
    residual is step state (`init_ef_fn`). `phase_timing=True` adds
    `timed_step_fn`, the same schedule with each phase timed. A
    hierarchical mesh composed with fsdp, sp, ep or tp needs `params_spec`
    too: the params and the rows are placed on `mesh.model_submesh(mesh)`
    (the batch split over fsdp there), and the sync runs on each rank's
    local gradient shards.
    """
    optimizer = optimizer or default_optimizer()
    hier = mesh_lib.is_hierarchical_mesh(mesh)
    if grad_quantize is not None and not hier:
        raise ValueError(
            "grad_quantize runs on the inter hop of a hierarchical mesh; "
            "build one with mesh.build_hierarchical_mesh")
    if phase_timing and not hier:
        raise ValueError(
            "phase_timing splits the two-level gradient sync into timed "
            "phases; build a hierarchical mesh "
            "(mesh.build_hierarchical_mesh) to use it")
    if phase_timing and grad_quantize is not None and \
            grad_quantize.error_feedback:
        raise ValueError(
            "phase_timing does not support error-feedback quantization "
            "(the residual is fused-step state)")
    sharded = None
    model_mesh = _model_mesh(mesh)
    if isinstance(mesh, DeviceMesh):
        device = _mesh_device(mesh, device)
        if model_mesh is not None:
            if params_spec is None:
                raise ValueError("a build_mesh mesh, or a hierarchical one "
                                 "composed with other axes, needs "
                                 "params_spec (the model's param_specs)")
            sharded = _Sharded(model_mesh, mesh_lib.rules_for_mesh(
                mesh, rules) if hier else rules, pipeline)
    else:
        device = _one_device(mesh, device)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params_fn(generator, device=device)
        if sharded is not None:
            params = shard_params(params, model_mesh, params_spec)
        if dp is not None:
            dp.layout(params)
        return TrainState(0, params, optimizer.init(params))

    def abstract_state() -> TrainState:
        with torch.device("meta"):
            params = init_params_fn(torch.Generator(), device="meta")
        return TrainState(0, params, optimizer.init(params))

    def local_grads(state: TrainState, batch) -> tuple:
        if sharded is not None:
            return sharded.grads(loss_fn, state, batch)
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        params = _tree_map(lambda p: p.detach().requires_grad_(),
                           state.params)
        leaves = _leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = iter(torch.autograd.grad(loss, leaves))
        return loss.detach(), _tree_map(lambda _: next(grads), params)

    def _apply(state: TrainState, grads) -> tuple:
        g_norm = optimizer.update(state.params, grads, state.opt_state)
        if sharded is not None:
            g_norm = g_norm.full_tensor()
        return TrainState(state.step + 1, state.params, state.opt_state), \
            g_norm

    def apply_fn(state: TrainState, grads) -> TrainState:
        return _apply(state, grads)[0]

    extra = {}
    if sharded is not None:
        meta = _tree_map(lambda _: torch.empty(0, device="meta"),
                         params_spec)
        extra = dict(mesh=mesh, state_sharding=state_shardings(
            TrainState(0, meta, optimizer.init(meta)), params_spec,
            model_mesh))
    if not hier:
        dp = None

        def step_fn(state: TrainState, batch) -> tuple:
            loss, grads = local_grads(state, batch)
            state, g_norm = _apply(state, grads)
            return state, {"loss": loss, "grad_norm": g_norm,
                           "step": state.step}

        if sharded is not None:
            extra["batch_sharding"] = sharded.batch_sharding
        return CompiledTrain(device=device, init_fn=init_fn, step_fn=step_fn,
                             grad_fn=local_grads, apply_fn=apply_fn,
                             abstract_state=abstract_state, **extra)

    dp = _DataParallel(mesh, grad_quantize, device)

    def synced(state, batch, quantize, residual=None) -> tuple:
        """(mean loss, averaged grads, new residual): the step before the
        update. The sync finishes before the optimizer touches params."""
        loss, grads = local_grads(state, _rank_rows(batch, dp.rank, dp.world))
        grads, residual = dp.sync(grads, state.step, quantize, residual)
        return dp.mean_loss(loss), grads, residual

    def grad_fn(state: TrainState, batch) -> tuple:
        return synced(state, batch, None)[:2]

    def sync_fn(state: TrainState, batch) -> tuple:
        zeros = init_ef_fn() if dp.ef else None
        return synced(state, batch, grad_quantize, zeros)[:2]

    def init_ef_fn() -> torch.Tensor:
        return torch.zeros(dp.layout()[1], dtype=torch.float32,
                           device=device)

    def step_fn(state: TrainState, batch, *ef) -> tuple:
        if len(ef) != int(dp.ef):
            raise TypeError("with error feedback the step is step_fn(state, "
                            "batch, ef) (init_ef_fn() seeds ef); without "
                            "it, step_fn(state, batch)")
        loss, grads, residual = synced(state, batch, grad_quantize, *ef)
        state, g_norm = _apply(state, grads)
        metrics = {"loss": loss, "grad_norm": g_norm, "step": state.step}
        return (state, metrics, residual) if dp.ef else (state, metrics)

    def timed_step_fn(state: TrainState, batch) -> tuple:
        phases = hier_phase_programs(dp.groups, grad_quantize)
        clock = _PhaseClock(device)
        loss, grads = local_grads(state, _rank_rows(batch, dp.rank, dp.world))
        vec = dp.bucket(grads)
        clock.mark("compute")
        for name in ("rs", "ar", "ag"):
            vec = phases[name](vec)
            clock.mark(name)
        state, g_norm = _apply(state, dp.unbucket(vec / dp.world, grads))
        clock.mark("apply")
        return state, {"loss": float(dp.mean_loss(loss)), "grad_norm": g_norm,
                       "step": state.step, "phases": clock.seconds()}

    extra["mesh"] = mesh
    return CompiledTrain(
        device=device, init_fn=init_fn, step_fn=step_fn, grad_fn=grad_fn,
        apply_fn=apply_fn, topology=dp.topo,
        grad_quantize=grad_quantize, sync_fn=sync_fn,
        init_ef_fn=init_ef_fn if dp.ef else None,
        timed_step_fn=timed_step_fn if phase_timing else None,
        abstract_state=abstract_state, **extra)


# ---------------------------------------------------------------------------
# World-size-agnostic state checkpoints
#
# save: every process writes the chunks it holds, with global index windows
# in the manifest (train/checkpoint.py save_sharded). restore: the leaves
# are gathered on the host (or streamed window by window) and placed under
# the program's state shardings, so a checkpoint saved at world size 4
# restores at 2, 1, or back at 4, bit for bit.
# ---------------------------------------------------------------------------

# the two leaves that carry AdamWState.count: optax's ScaleByAdamState count
# and its schedule's count (equal: both count the updates)
_COUNT_KEYS = ("opt_state/1/0/.count", "opt_state/1/2/.count")


def _state_as_tree(state: TrainState) -> dict:
    """The state as the JAX package's tree of it, so leaf keys are its
    path strings: ``step``, ``params/<path>``, and optax's
    ``chain(clip_by_global_norm, adamw)`` state ``opt_state/1/0/.count``,
    ``opt_state/1/0/.mu/<path>``, ``opt_state/1/0/.nu/<path>`` and
    ``opt_state/1/2/.count`` (the clip and the weight decay keep no
    leaves)."""
    opt = state.opt_state
    return {"step": state.step, "params": state.params,
            "opt_state": {"1": {"0": {".count": opt.count, ".mu": opt.mu,
                                      ".nu": opt.nu},
                                "2": {".count": opt.count}}}}


def save_state_sharded(state: TrainState, path: str, *,
                       world_size: int = 1, process_index: int = 0) -> str:
    """Write `state` as a sharded checkpoint (every rank of a mesh calls it
    with its own `process_index`; each writes its own shards). The step
    and both counts are int32 scalars, as the JAX package writes them."""
    from ray_tpu_torch.train import checkpoint as ckpt_lib

    opt = state.opt_state
    count = np.int32(opt.count)
    tree = _state_as_tree(TrainState(
        np.int32(state.step), state.params,
        dataclasses.replace(opt, count=count)))
    return ckpt_lib.save_sharded(tree, path, step=int(state.step),
                                 world_size=world_size,
                                 process_index=process_index)


def restore_state_sharded(path: str, compiled: CompiledTrain, *,
                          stream_chunk_bytes: Optional[int] = None,
                          stream_in_flight: int = 2) -> TrainState:
    """Restore a `save_state_sharded` checkpoint (of either package) onto
    `compiled`: under `compiled.state_sharding` on a `build_mesh` mesh,
    which may differ in shape and size from the mesh it was saved on, each
    rank taking only its own index window (`collective.reshard`); else onto
    `compiled.device`. A leaf whose type differs from the program's is
    cast to it; bf16 bits are never cast on the way.

    With `stream_chunk_bytes` set the restore STREAMS instead of
    gathering: each leaf is opened lazily (`checkpoint.open_sharded`) and
    read window by window (`collective.reshard_streaming`), so peak host
    memory is about `stream_in_flight * stream_chunk_bytes` rather than the
    model size. Bitwise-identical to the gathering path."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train import checkpoint as ckpt_lib
    from ray_tpu_torch.util.collective.reshard import (
        reshard, reshard_streaming, stream_window)

    stream = stream_chunk_bytes is not None
    flat, manifest = (ckpt_lib.open_sharded(path) if stream
                      else ckpt_lib.load_sharded(path))
    template = ckpt_lib._flatten_with_path(
        _state_as_tree(compiled.abstract_state()))
    shardings = {}
    if compiled.state_sharding is not None:
        shardings = {ckpt_lib._leaf_key(kp): s for kp, s in
                     ckpt_lib._flatten_with_path(
                         _state_as_tree(compiled.state_sharding))}

    def as_leaf(t: torch.Tensor, saved: str, want) -> torch.Tensor:
        if saved == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(want)

    restored = {}
    for kp, leaf in template:
        key = ckpt_lib._leaf_key(kp)
        if key not in flat:
            raise KeyError(f"checkpoint {path} has no leaf {key!r}")
        arr, saved = flat[key], manifest["params"][key]["dtype"]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {key}: checkpoint shape "
                             f"{tuple(arr.shape)} != program shape {shape}")
        if not isinstance(leaf, torch.Tensor):    # the step and the counts
            restored[key] = int(np.asarray(arr.read(()) if stream else arr))
        elif stream and key in shardings:
            d = reshard_streaming(arr, shardings[key],
                                  chunk_bytes=stream_chunk_bytes,
                                  max_in_flight=stream_in_flight)
            restored[key] = DTensor.from_local(
                as_leaf(d.to_local(), saved, leaf.dtype), d.device_mesh,
                d.placements, shape=d.shape, stride=d.stride())
        elif stream:
            restored[key] = as_leaf(stream_window(
                arr, tuple((0, n) for n in shape), compiled.device,
                chunk_bytes=stream_chunk_bytes,
                max_in_flight=stream_in_flight), saved, leaf.dtype)
        else:
            t = as_leaf(torch.from_numpy(np.ascontiguousarray(arr)), saved,
                        leaf.dtype)
            restored[key] = (reshard(t, shardings[key]) if key in shardings
                             else t.to(compiled.device))
    counts = {restored.pop(k) for k in _COUNT_KEYS}
    if len(counts) != 1:
        raise ValueError(f"checkpoint {path}: the optimizer's counts "
                         f"{_COUNT_KEYS} differ ({sorted(counts)}); the "
                         f"port keeps one")
    tree = nest(restored)
    return TrainState(step=tree["step"], params=tree["params"],
                      opt_state=AdamWState(counts.pop(),
                                           tree["opt_state"]["1"]["0"][".mu"],
                                           tree["opt_state"]["1"]["0"][".nu"]))


def cross_worker_grad_sync(grads: Tree, group_name: str, world_size: int,
                           quantize=None, timeout: float = 60.0) -> Tree:
    """Average a gradient tree across the worker gang (elastic DDP): one
    fused f32 bucket through the gang's hierarchical `allreduce_tree`
    (`util.collective.DistCollectiveGroup`), its inter hop int8/fp8 with
    `quantize`. No-op at world size 1. `group_name` should carry the
    group's generation (e.g. "ddp:g3").

    A `kv` group (the CPU-only fallback, over the head's KV) has no device
    path: as in the JAX package, the leaves (sorted-key order) go into one
    fused f32 host buffer, allreduced once and divided by the world size,
    each leaf cast back to its dtype and device. `timeout` bounds that
    rendezvous only."""
    if world_size <= 1:
        return grads
    from ray_tpu_torch.util import collective

    group = collective.get_group(group_name)
    if hasattr(group, "allreduce_tree"):
        return group.allreduce_tree(grads, average=True, quantize=quantize)
    parts = [g.detach().to("cpu", torch.float32).reshape(-1).numpy()
             for g in _leaves(grads)]
    fused = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    group.allreduce(fused, timeout=timeout)
    fused /= world_size
    pieces = iter(np.split(fused, np.cumsum([p.size for p in parts])[:-1]))
    return _tree_map(lambda g: torch.from_numpy(next(pieces).copy()).view(
        g.shape).to(g.device, g.dtype), grads)


def compile_model_train(model_mod, cfg, mesh=None, optimizer=None,
                        device=None, grad_quantize=None,
                        phase_timing: bool = False) -> CompiledTrain:
    """compile_train for a model module exposing loss_fn / init_params /
    param_specs (ray_tpu_torch.models.{gpt2,llama,moe})."""
    spec = model_mod.param_specs(cfg) if _model_mesh(mesh) is not None \
        else None
    return compile_train(
        loss_fn=functools.partial(model_mod.loss_fn, cfg=cfg),
        init_params_fn=functools.partial(model_mod.init_params, cfg=cfg),
        mesh=mesh, optimizer=optimizer, device=device,
        grad_quantize=grad_quantize, phase_timing=phase_timing,
        params_spec=spec)


def compile_gpt2_train(cfg, mesh=None, optimizer=None, device=None,
                       grad_quantize=None,
                       phase_timing: bool = False) -> CompiledTrain:
    from ray_tpu_torch.models import gpt2

    return compile_model_train(gpt2, cfg, mesh, optimizer, device,
                               grad_quantize, phase_timing)


def compile_pipeline_train(model_mod, cfg, mesh, n_microbatches: int,
                           optimizer=None, rules=None,
                           device=None) -> CompiledTrain:
    """Pipeline-parallel training (the JAX package's
    `compile_pipeline_train`): the block stack runs as a GPipe microbatch
    pipeline over the mesh's `pp` axis (`parallel.pipeline`), while the
    embedding, the unembed and the loss run as on any mesh, replicated
    over pp. For models whose blocks are layer-stacked with a
    `_block(x, bp, cfg)` body (gpt2, llama).

    `mesh` is either
    - a `build_mesh` mesh with pp (composed with dp, fsdp, sp, ep and tp;
      with sp the activation stays split over its sequence inside each
      stage, whose attention runs ring or Ulysses on the stage's sub-mesh,
      K1-K3 on the ring's chunk pairs): the
      stacked layer dim is split over pp (the rule "layers": "pp"), so each
      rank holds only its stage's layers, and this rank runs its stage; or
    - a `MeshConfig` (or mapping) of pp alone: its F stages run in this
      process on `device`, their hops in memory (one card standing in for
      a pipeline), the same schedule and arithmetic as F ranks."""
    from ray_tpu_torch.models.lm import cross_entropy, split_lm_batch
    from ray_tpu_torch.parallel.pipeline import (make_stage_fn,
                                                 pipeline_apply, stack_stages)

    if not all(hasattr(model_mod, f) for f in ("embed", "_block",
                                                 "unembed")):
        raise NotImplementedError(
            f"compile_pipeline_train pipelines gpt2 and llama, whose blocks "
            f"map x to x between embed and unembed, as the JAX package's "
            f"does; {model_mod.__name__}'s blocks carry the router's aux "
            f"loss and it has no embed/unembed: train it with "
            f"compile_model_train")
    if mesh_lib.is_hierarchical_mesh(mesh):
        raise NotImplementedError(
            "compile_pipeline_train on a hierarchical mesh: the JAX "
            "package's pipeline fails there (its shard_map nested in the "
            "fused sync's raises \"The context mesh ... should match the "
            "mesh passed to shard_map\"), so the port refuses it (ROADMAP "
            "queue 3); pipeline over a build_mesh mesh with pp and dp")
    virtual = not isinstance(mesh, DeviceMesh)
    if virtual:
        config = mesh if isinstance(mesh, mesh_lib.MeshConfig) \
            else mesh_lib.MeshConfig(**dict(mesh))
        others = {a: v for a, v in config.degrees().items()
                  if a != "pp" and v != 1}
        if others:
            raise ValueError(f"virtual stages share one device: a "
                             f"MeshConfig of pp alone, got {others} too; "
                             f"other axes need a build_mesh mesh")
        F = config.pp
    else:
        F = mesh_lib.axis_size(mesh, "pp")
    if cfg.n_layer % max(F, 1):
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pp={F}")
    remat = getattr(cfg, "remat_policy", "full") if cfg.remat else None
    stage_fn = make_stage_fn(lambda x, bp: model_mod._block(x, bp, cfg),
                             remat)

    def loss_fn(params, batch):
        inputs, targets = split_lm_batch(batch)
        x = model_mod.embed(params, inputs, cfg)
        x = pipeline_apply(stage_fn, stack_stages(params["blocks"], F), x,
                           n_microbatches=n_microbatches,
                           mesh=None if virtual else mesh)
        return cross_entropy(model_mod.unembed(params, x, cfg), targets)

    init = functools.partial(model_mod.init_params, cfg=cfg)
    if virtual:
        return compile_train(loss_fn, init, optimizer=optimizer,
                             device=device)
    rules = {**(rules or {}), "layers": "pp"}
    with mesh_lib.use_mesh(mesh, rules):
        spec = model_mod.param_specs(cfg)
    return compile_train(loss_fn, init, mesh=mesh, optimizer=optimizer,
                         device=device, params_spec=spec, rules=rules,
                         pipeline=True)
