"""Minimal environment API + built-in envs (numpy, CPU-side).

The reference's RLlib consumes gymnasium envs (`rllib/env/single_agent_env_runner.py`
wraps `gym.vector`); gymnasium is not in this image, so the framework ships a
gymnasium-compatible surface (`reset(seed)->(obs, info)`,
`step(a)->(obs, reward, terminated, truncated, info)`) plus classic-control
envs used by the reference's own CI (CartPole, Pendulum). User envs following
the same protocol — including real gymnasium envs, which match it exactly —
plug in via ``config.environment(env_creator)``.

Rollouts are host-side numpy by design: the card runs the learner update;
env physics stays on the CPU in env-runner actors.

Counterpart of `ray_tpu/rllib/env/envs.py`, copied: the same seed and
actions give the same observations and rewards bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(self.n))

    @property
    def shape(self):
        return ()


@dataclasses.dataclass(frozen=True)
class Box:
    low: Any
    high: Any
    shape: Tuple[int, ...]

    def sample(self, rng: np.random.Generator):
        return rng.uniform(self.low, self.high, size=self.shape).astype(np.float32)


class Env:
    """Gymnasium-compatible single env protocol."""

    observation_space: Any
    action_space: Any

    def reset(self, *, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        raise NotImplementedError

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CartPole(Env):
    """Classic cart-pole balancing (dynamics per Barto-Sutton-Anderson 1983,
    matching gymnasium CartPole-v1: +1 reward/step, 500-step truncation)."""

    def __init__(self, max_episode_steps: int = 500):
        self.observation_space = Box(-np.inf, np.inf, (4,))
        self.action_space = Discrete(2)
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self._state = None
        self._t = 0
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.length = 0.5          # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_limit = 12 * 2 * np.pi / 360
        self.x_limit = 2.4

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=(4,))
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if action == 1 else -self.force_mag
        costh, sinth = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sinth) / total_mass
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh**2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * x_acc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1
        terminated = bool(abs(x) > self.x_limit or abs(theta) > self.theta_limit)
        truncated = self._t >= self.max_episode_steps
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


class Pendulum(Env):
    """Torque-controlled pendulum swing-up (gymnasium Pendulum-v1 dynamics)."""

    def __init__(self, max_episode_steps: int = 200):
        self.observation_space = Box(-np.inf, np.inf, (3,))
        self.action_space = Box(-2.0, 2.0, (1,))
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self.dt, self.g, self.m, self.l = 0.05, 10.0, 1.0, 1.0
        self._th = self._thdot = 0.0
        self._t = 0

    def _obs(self):
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        dtype=np.float32)

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                         + 3.0 / (self.m * self.l**2) * u) * self.dt
        thdot = float(np.clip(thdot, -8.0, 8.0))
        th = th + thdot * self.dt
        self._th, self._thdot = th, thdot
        self._t += 1
        return self._obs(), -cost, False, self._t >= self.max_episode_steps, {}


_REGISTRY: dict = {"CartPole-v1": CartPole, "Pendulum-v1": Pendulum}


def register_env(name: str, creator: Callable[..., Env]) -> None:
    """Reference parity: `ray.tune.registry.register_env`."""
    _REGISTRY[name] = creator


def make_env(spec, **kwargs) -> Env:
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise ValueError(f"unknown env {spec!r}; registered: {sorted(_REGISTRY)}")
        return _REGISTRY[spec](**kwargs)
    if isinstance(spec, Env):
        return spec
    return spec(**kwargs)  # creator callable / class


class VectorEnv:
    """N independent envs stepped as a batch with auto-reset on episode end
    (the vectorization the reference gets from `gymnasium.vector.SyncVectorEnv`)."""

    def __init__(self, spec, num_envs: int, seed: int = 0, **kwargs):
        self.envs = [make_env(spec, **kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed
        self._returns = np.zeros(num_envs)

    def reset(self) -> np.ndarray:
        obs = [e.reset(seed=self._seed + i)[0] for i, e in enumerate(self.envs)]
        self._seed += self.num_envs
        self._returns[:] = 0.0
        return np.stack(obs)

    def step(self, actions):
        """Returns (obs, rewards, terminateds, truncateds, final_obs,
        episode_returns). Finished envs auto-reset: `obs` then holds the
        reset observation while `final_obs` holds the pre-reset one (needed
        to bootstrap through time-limit truncation, the reason gymnasium
        splits terminated from truncated). `episode_returns` carries the
        completed-episode return at finished positions (nan elsewhere)."""
        obs, rews, terms, truncs = [], [], [], []
        final_obs = np.zeros((self.num_envs,) + tuple(
            self.observation_space.shape), np.float32)
        ep_returns = np.full(self.num_envs, np.nan)
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc, _ = e.step(a)
            self._returns[i] += r
            final_obs[i] = o
            if term or trunc:
                ep_returns[i] = self._returns[i]
                self._returns[i] = 0.0
                o, _ = e.reset(seed=self._seed)
                self._seed += 1
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
        return (np.stack(obs), np.array(rews, dtype=np.float32),
                np.array(terms, dtype=bool), np.array(truncs, dtype=bool),
                final_obs, ep_returns)

    def start(self):
        """Reset all sub-envs and zero episode-return accounting."""
        return self.reset()
