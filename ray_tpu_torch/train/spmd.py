"""Training step on one device (counterpart of `ray_tpu/train/spmd.py`).

The JAX module compiles a mesh-sharded step with `jit` and donates the state
so XLA updates the weights in place. Here the step runs eagerly on one
device and updates params and optimizer moments IN PLACE: the `TrainState`
a step returns holds the same tensors as the one it was given, so a caller
that wants the old weights copies them first.

- `default_optimizer` is optax's ``chain(clip_by_global_norm(clip),
  adamw(warmup_cosine_decay_schedule(...)))`` written out by hand, step for
  step as optax 0.2.6 computes it (the card's host has no optax);
- `compile_train` / `compile_model_train` / `compile_gpt2_train` return a
  `CompiledTrain` with `init_fn`, the fused `step_fn` and the split
  `grad_fn` / `apply_fn` of the JAX flat path.

A mesh across devices (data, fsdp, tensor, sequence or pipeline parallel),
the hierarchical and quantized gradient sync and `phase_timing` need the
collective slice of the port and raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_tpu_torch.utils.platform import default_device

Tree = Any  # nested dict of tensors, as the models' params


def _leaves(tree: Tree) -> list:
    """Leaves in sorted-key order (the order JAX flattens a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _tree_map(fn: Callable, tree: Tree) -> Tree:
    """fn on every leaf, visited in the order of `_leaves`."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in _leaves(tree)))


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree
    opt_state: Any


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
    """A training program bound to one device."""
    device: torch.device
    init_fn: Callable[[torch.Generator], TrainState]   # generator -> state
    step_fn: Callable[[TrainState, Any], tuple]        # -> (state, metrics)
    # the step split in two, for a caller that averages the gradients
    # between the calls: (state, batch) -> (loss, grads) and
    # (state, grads) -> state
    grad_fn: Callable[[TrainState, Any], tuple]
    apply_fn: Callable[[TrainState, Any], TrainState]


def _one_device(mesh, device) -> torch.device:
    if mesh is not None:
        devs = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
        if len(devs) != 1 or not isinstance(devs[0], (str, torch.device)):
            raise NotImplementedError(
                "training across devices (a mesh with data, fsdp, tensor, "
                "sequence or pipeline axes) needs the collective slice of "
                "the port (torch.distributed); pass mesh=None or one device")
        device = device if device is not None else devs[0]
    return default_device(device)


def compile_train(loss_fn: Callable[[Tree, Any], torch.Tensor],
                  init_params_fn: Callable[..., Tree], mesh=None,
                  optimizer: Optional[AdamW] = None,
                  device=None) -> CompiledTrain:
    """Build init and step functions for any model on one device.

    loss_fn(params, batch) -> scalar; init_params_fn(generator, device=...)
    -> params. Batches are dicts of tensors or numpy arrays, moved to the
    device by the step. The step updates params and moments in place (see
    the module docstring).
    """
    device = _one_device(mesh, device)
    optimizer = optimizer or default_optimizer()

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params_fn(generator, device=device)
        return TrainState(0, params, optimizer.init(params))

    def grad_fn(state: TrainState, batch) -> tuple:
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
        return TrainState(state.step + 1, state.params, state.opt_state), \
            g_norm

    def apply_fn(state: TrainState, grads) -> TrainState:
        return _apply(state, grads)[0]

    def step_fn(state: TrainState, batch) -> tuple:
        loss, grads = grad_fn(state, batch)
        state, g_norm = _apply(state, grads)
        return state, {"loss": loss, "grad_norm": g_norm, "step": state.step}

    return CompiledTrain(device=device, init_fn=init_fn, step_fn=step_fn,
                         grad_fn=grad_fn, apply_fn=apply_fn)


def compile_model_train(model_mod, cfg, mesh=None, optimizer=None,
                        device=None) -> CompiledTrain:
    """compile_train for a model module exposing loss_fn / init_params
    (ray_tpu_torch.models.gpt2)."""
    return compile_train(
        loss_fn=functools.partial(model_mod.loss_fn, cfg=cfg),
        init_params_fn=functools.partial(model_mod.init_params, cfg=cfg),
        mesh=mesh, optimizer=optimizer, device=device)


def compile_gpt2_train(cfg, mesh=None, optimizer=None,
                       device=None) -> CompiledTrain:
    from ray_tpu_torch.models import gpt2

    return compile_model_train(gpt2, cfg, mesh, optimizer, device)
