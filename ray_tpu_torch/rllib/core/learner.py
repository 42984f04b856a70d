"""Learner: gradient updates of an RLModule on one device.

Parity: `rllib/core/learner/learner.py:106` + the torch learner
(`rllib/core/learner/torch/torch_learner.py:432`).

Counterpart of `ray_tpu/rllib/core/learner.py`, whose `JaxLearner` is
`Learner` here. `update(batch)` is the loss, autograd, then optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))``, applied by the
trainer's optax-exact `AdamW` (no weight decay, a constant rate): not
`torch.optim.Adam`, whose epsilon and clip differ. The JAX package's
single-controller dp mesh (`mesh=`) is not ported: the port's data
parallel runs one process a device, so the learner's needs a design of its
own (ROADMAP item 14b).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (ModuleSpec, RLModule,
                                                flatten, params_from_numpy,
                                                params_to_numpy)
from ray_tpu_torch.train.spmd import AdamW, AdamWState
from ray_tpu_torch.utils.platform import default_device

Params = Any


class Learner:
    """Subclasses define `loss(params, batch, gen) -> (scalar, metrics)`."""

    def __init__(self, module_spec: ModuleSpec, *, lr: float = 3e-4,
                 grad_clip: Optional[float] = 0.5, seed: int = 0,
                 device=None):
        self.device = default_device(device)
        self.module = RLModule(module_spec)
        rate = np.float32(lr)
        self.optimizer = AdamW(lambda count: rate, b1=0.9, b2=0.999,
                               weight_decay=0.0,
                               clip=grad_clip if grad_clip else math.inf)
        # the loss's stream (the JAX learner's `_rng`); PPO's draws nothing
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._set_params(self.module.init(
            torch.Generator().manual_seed(seed + 1), self.device))
        self.opt_state = self.optimizer.init(self._flat)

    def _set_params(self, params: Params) -> None:
        self.params = params
        # the same tensors by path: the optimizer updates them in place
        self._flat = flatten(params)

    # ----------------------------------------------------------------- loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             gen: torch.Generator) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    # --------------------------------------------------------------- update
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        # "_"-prefixed keys are auxiliary trees (e.g. DQN target params)
        return {k: v if k.startswith("_")
                else torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def update(self, batch: Dict[str, Any]) -> dict:
        """One step on `batch` (numpy arrays or tensors on any device);
        returns the loss's metrics, `total_loss` and `grad_norm` (before
        clipping) as floats, read in one copy."""
        leaves = list(self._flat.values())
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                total, metrics = self.loss(self.params,
                                           self._to_device(batch), self._gen)
                grads = torch.autograd.grad(total, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        g_norm = self.optimizer.update(self._flat,
                                       dict(zip(self._flat, grads)),
                                       self.opt_state)
        metrics = {**metrics, "total_loss": total, "grad_norm": g_norm}
        values = torch.stack([v.detach().float().reshape(())
                              for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    # ---------------------------------------------------------- checkpoints
    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, params) -> None:
        # Adam's moments stay, keyed by path
        self._set_params(params_from_numpy(params, self.device))

    def get_state(self) -> dict:
        """Params and Adam's state as numpy, params in the JAX package's
        layout; the moments path-keyed ("pi/0/w")."""
        st = self.opt_state
        return {"params": self.get_weights(),
                "opt_state": {"count": st.count,
                              "mu": params_to_numpy(st.mu),
                              "nu": params_to_numpy(st.nu)}}

    def set_state(self, state: dict) -> None:
        self._set_params(params_from_numpy(state["params"], self.device))
        st = state["opt_state"]
        self.opt_state = AdamWState(
            int(st["count"]), params_from_numpy(st["mu"], self.device),
            params_from_numpy(st["nu"], self.device))
