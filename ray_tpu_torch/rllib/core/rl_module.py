"""RLModule: policy/value networks + action distributions, plain torch.

Parity target: the reference's RLModule abstraction
(`rllib/core/rl_module/rl_module.py` — forward_inference / forward_exploration
/ forward_train) done as pure functions over parameter trees, as the port's
models are.

Counterpart of `ray_tpu/rllib/core/rl_module.py`. The params keep the JAX
package's layout (``{"pi": [{"w", "b"}, ...], "vf": [...], "log_std"}``,
``w`` as [fan_in, fan_out]), so `params_from_numpy` carries that package's
weights in and the two compute the same functions from them. Init draws
from an explicit `torch.Generator` (orthogonal, as `jax.nn.initializers.
orthogonal`, from other draws), and sampling takes one too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.utils.platform import default_device

Params = Any

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _init_mlp(gen: torch.Generator, sizes: Sequence[int],
              scale_last: float = 0.01) -> Params:
    """Orthogonal-init MLP (the reference's default for PPO-style nets)."""
    layers = []
    n = len(sizes) - 1
    for i in range(n):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        w = torch.empty(fan_in, fan_out)
        torch.nn.init.orthogonal_(
            w, gain=float(np.sqrt(2)) if i < n - 1 else scale_last,
            generator=gen)
        layers.append({"w": w, "b": torch.zeros(fan_out)})
    return layers


def _apply_mlp(layers: Params, x: torch.Tensor) -> torch.Tensor:
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _map(fn, tree: Params) -> Params:
    """fn on every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def flatten(tree: Params, prefix: str = "") -> dict:
    """Path-keyed leaves ("pi/0/w") of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def params_from_numpy(tree: Params, device=None) -> Params:
    """A tree of numpy leaves in the JAX package's layout (its learner's
    `get_weights`) -> the same tree of float32 tensors on `device`."""
    device = default_device(device)
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(params: Params) -> Params:
    """The inverse of `params_from_numpy`."""
    return _map(lambda t: t.detach().cpu().numpy(), params)


@dataclasses.dataclass(frozen=True)
class ModuleSpec:
    """What the reference calls RLModuleSpec (`rllib/core/rl_module/rl_module.py`)."""
    obs_dim: int
    action_dim: int
    discrete: bool
    hiddens: Tuple[int, ...] = (64, 64)
    # DQN-style modules output one Q-value per action instead of a policy head
    q_network: bool = False
    # SAC-style modules: tanh-squashed state-dependent Gaussian + twin Q(s,a)
    squashed: bool = False
    # Box envs with bounds beyond [-1, 1]: policy outputs are scaled by this
    action_scale: float = 1.0


class RLModule:
    """Separate policy and value MLP towers (reference default catalog config)."""

    def __init__(self, spec: ModuleSpec):
        self.spec = spec

    def init(self, gen: torch.Generator, device=None) -> Params:
        """Params drawn from `gen` (a CPU generator: the same draws on any
        device), placed on `device` (None: the card)."""
        s = self.spec
        head = 2 * s.action_dim if s.squashed else s.action_dim
        params = {
            "pi": _init_mlp(gen, (s.obs_dim, *s.hiddens, head),
                            scale_last=1.0 if s.q_network else 0.01),
            "vf": _init_mlp(gen, (s.obs_dim, *s.hiddens, 1), scale_last=1.0),
        }
        if s.squashed:
            params["q1"] = _init_mlp(
                gen, (s.obs_dim + s.action_dim, *s.hiddens, 1), scale_last=1.0)
            params["q2"] = _init_mlp(
                gen, (s.obs_dim + s.action_dim, *s.hiddens, 1), scale_last=1.0)
        elif not s.discrete and not s.q_network:
            params["log_std"] = torch.zeros(s.action_dim)
        device = default_device(device)
        return _map(lambda t: t.to(device), params)

    def q_values(self, params: Params, obs, act
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], dim=-1)
        return (_apply_mlp(params["q1"], x)[..., 0],
                _apply_mlp(params["q2"], x)[..., 0])

    # --- forward passes (reference: forward_inference/_exploration/_train) ---
    def value(self, params: Params, obs) -> torch.Tensor:
        return _apply_mlp(params["vf"], obs)[..., 0]

    def pi_out(self, params: Params, obs) -> torch.Tensor:
        """Logits (discrete / q_network) or mean (continuous)."""
        return _apply_mlp(params["pi"], obs)

    def dist(self, params: Params, obs):
        out = self.pi_out(params, obs)
        if self.spec.discrete or self.spec.q_network:
            return Categorical(out)
        if self.spec.squashed:
            mean, log_std = torch.chunk(out, 2, dim=-1)
            return SquashedGaussian(mean, torch.clamp(log_std, -20.0, 2.0))
        return DiagGaussian(out, params["log_std"])


def _normal(shape, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=like.device,
                       dtype=like.dtype)


class Categorical:
    def __init__(self, logits):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    def sample(self, gen: torch.Generator):
        # Gumbel-max, as jax.random.categorical draws
        u = torch.rand(self.logits.shape, generator=gen,
                       device=self.logits.device, dtype=self.logits.dtype)
        tiny = torch.finfo(self.logits.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def log_prob(self, a):
        return torch.gather(self.logits, -1, a[..., None].long())[..., 0]

    def entropy(self):
        p = torch.exp(self.logits)
        return -torch.sum(p * self.logits, dim=-1)

    def kl(self, other: "Categorical"):
        p = torch.exp(self.logits)
        return torch.sum(p * (self.logits - other.logits), dim=-1)

    def mode(self):
        return torch.argmax(self.logits, dim=-1)


class DiagGaussian:
    def __init__(self, mean, log_std):
        self.mean, self.log_std = mean, log_std

    def sample(self, gen: torch.Generator):
        return self.mean + torch.exp(self.log_std) * _normal(
            self.mean.shape, gen, self.mean)

    def log_prob(self, a):
        var = torch.exp(2 * self.log_std)
        return torch.sum(-((a - self.mean) ** 2) / (2 * var) - self.log_std
                         - _HALF_LOG_2PI, dim=-1)

    def entropy(self):
        return torch.sum(self.log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)

    def kl(self, other: "DiagGaussian"):
        var, ovar = torch.exp(2 * self.log_std), torch.exp(2 * other.log_std)
        return torch.sum(other.log_std - self.log_std
                         + (var + (self.mean - other.mean) ** 2) / (2 * ovar)
                         - 0.5, dim=-1)

    def mode(self):
        return self.mean


def _tanh_log_det(u):
    # log|det tanh'(u)| = sum 2(log2 - u - softplus(-2u))
    return torch.sum(2 * (math.log(2.0) - u - F.softplus(-2 * u)), dim=-1)


class SquashedGaussian:
    """tanh(Normal) with the change-of-variables log-prob correction
    (reference: `rllib/models/torch/torch_distributions.py` TorchSquashedGaussian)."""

    def __init__(self, mean, log_std):
        self.mean, self.log_std = mean, log_std

    def _base(self):
        return DiagGaussian(self.mean, self.log_std)

    def sample_with_logp(self, gen: torch.Generator):
        u = self.mean + torch.exp(self.log_std) * _normal(
            self.mean.shape, gen, self.mean)
        return torch.tanh(u), self._base().log_prob(u) - _tanh_log_det(u)

    def sample(self, gen: torch.Generator):
        return self.sample_with_logp(gen)[0]

    def log_prob(self, a):
        u = torch.atanh(torch.clamp(a, -1 + 1e-6, 1 - 1e-6))
        return self._base().log_prob(u) - _tanh_log_det(u)

    def entropy(self):
        return self._base().entropy()  # gaussian entropy (upper bound)

    def mode(self):
        return torch.tanh(self.mean)


def spec_from_env(env) -> ModuleSpec:
    from ray_tpu_torch.rllib.env.envs import Discrete

    space = env.action_space
    if isinstance(space, Discrete):
        return ModuleSpec(obs_dim=int(np.prod(env.observation_space.shape)),
                          action_dim=space.n, discrete=True)
    return ModuleSpec(obs_dim=int(np.prod(env.observation_space.shape)),
                      action_dim=int(np.prod(space.shape)), discrete=False,
                      action_scale=float(np.max(np.abs(
                          np.asarray([space.low, space.high])))))
