"""EnvRunner: vectorized rollout collection with one policy step a batch.

Parity: `rllib/env/single_agent_env_runner.py` (sample() over vectorized
gymnasium envs): action selection batches across the env vector.

Counterpart of `ray_tpu/rllib/env/env_runner.py`, whose jitted step is an
eager `torch.no_grad` step on the runner's device here, drawing from the
runner's own generator (seeded with seed + 17, as the JAX runner's key).
The observations cross to the device once a step; actions, log-probs and
values come back as numpy. The tail's bootstrap value is a value pass only
(the JAX runner runs a whole policy step there and keeps its value).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (ModuleSpec, RLModule,
                                                params_from_numpy)
from ray_tpu_torch.rllib.env.envs import VectorEnv
from ray_tpu_torch.utils.platform import default_device


class SingleAgentEnvRunner:
    """Collects fixed-length rollout fragments; usable in-process or as an
    actor via EnvRunnerGroup (`rllib/env/env_runner_group.py`)."""

    def __init__(self, env_spec, module_spec: ModuleSpec, num_envs: int = 1,
                 seed: int = 0, explore: bool = True,
                 epsilon: Optional[float] = None, env_kwargs: Optional[dict] = None,
                 env_to_module_connector=None,
                 module_to_env_connector=None, device=None):
        from ray_tpu_torch.rllib.connectors import build_pipeline

        self._env_spec = env_spec
        self._env_kwargs = dict(env_kwargs or {})
        # connector pipelines (reference rllib/connectors): per-runner
        # stateful transforms between env and module
        self.env_to_module = build_pipeline(env_to_module_connector)
        self.module_to_env = build_pipeline(module_to_env_connector)
        self.vec = VectorEnv(env_spec, num_envs, seed=seed, **self._env_kwargs)
        self.module = RLModule(module_spec)
        self.device = default_device(device)
        self.explore = explore
        self.epsilon = epsilon  # when set: epsilon-greedy over q-values (DQN)
        self._gen = torch.Generator(self.device).manual_seed(seed + 17)
        self._obs = self.vec.start()
        self._ep_returns: list = []
        self._params = None

    def set_weights(self, params) -> None:
        """Numpy leaves (the learner's `get_weights`) onto this device."""
        self._params = params_from_numpy(params, self.device)

    def get_weights(self):
        return self._params

    def _tensor(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(obs, device=self.device)

    @torch.no_grad()
    def _policy_step(self, obs: np.ndarray, eps: float):
        obs_t = self._tensor(obs)
        dist = self.module.dist(self._params, obs_t)
        if self.epsilon is not None:
            greedy = dist.mode()
            rand = torch.randint(0, self.module.spec.action_dim, greedy.shape,
                                 generator=self._gen, device=self.device)
            take_rand = torch.rand(greedy.shape, generator=self._gen,
                                   device=self.device) < eps
            a = torch.where(take_rand, rand, greedy)
            logp = torch.zeros(a.shape[0], device=self.device)
        elif self.explore:
            a = dist.sample(self._gen)
            logp = dist.log_prob(a)
        else:
            a = dist.mode()
            logp = dist.log_prob(a)
        v = self.module.value(self._params, obs_t)
        return a.cpu().numpy(), logp.cpu().numpy(), v.cpu().numpy()

    @torch.no_grad()
    def _value(self, obs: np.ndarray) -> np.ndarray:
        return self.module.value(self._params, self._tensor(obs)).cpu().numpy()

    @torch.no_grad()
    def _greedy(self, obs: np.ndarray) -> np.ndarray:
        return self.module.dist(self._params,
                                self._tensor(obs)).mode().cpu().numpy()

    def sample(self, num_steps: int, epsilon: float = 0.0) -> Dict[str, np.ndarray]:
        """Collect `num_steps` env steps per sub-env. Returns a flat batch with
        [T, N, ...] leaves plus bootstrap values for GAE."""
        assert self._params is not None, "set_weights() before sample()"
        obs_buf, act_buf, rew_buf, logp_buf, val_buf = ([] for _ in range(5))
        term_buf, trunc_buf, next_buf, finalv_buf = ([] for _ in range(4))
        for _ in range(num_steps):
            mod_obs = (self.env_to_module(self._obs)
                       if self.env_to_module else self._obs)
            a_np, logp, v = self._policy_step(mod_obs, epsilon)
            obs_buf.append(mod_obs)
            env_a = a_np if self.module.spec.discrete else \
                a_np * self.module.spec.action_scale
            if self.module_to_env is not None:
                env_a = self.module_to_env(env_a)
            next_obs, r, term, trunc, final_obs, ep_ret = self.vec.step(env_a)
            act_buf.append(a_np)
            rew_buf.append(r)
            term_buf.append(term)
            trunc_buf.append(trunc)
            # the true successor state: pre-reset final obs at episode ends
            next_buf.append(final_obs)
            # V(final_obs) where truncated (not terminated): lets consumers
            # bootstrap through time limits (gymnasium-correct semantics)
            boot = trunc & ~term
            fv = np.zeros(self.vec.num_envs, np.float32)
            if boot.any():
                bobs = (self.env_to_module.transform(final_obs[boot])
                        if self.env_to_module else final_obs[boot])
                fv[boot] = self._value(bobs)
            finalv_buf.append(fv)
            logp_buf.append(logp)
            val_buf.append(v)
            self._ep_returns.extend(ep_ret[~np.isnan(ep_ret)].tolist())
            self._obs = next_obs
        tail_obs = (self.env_to_module.transform(self._obs)
                    if self.env_to_module else self._obs)
        last_v = self._value(tail_obs)
        terms = np.stack(term_buf)
        truncs = np.stack(trunc_buf)
        return {
            "obs": np.stack(obs_buf), "actions": np.stack(act_buf),
            "rewards": np.stack(rew_buf), "dones": terms | truncs,
            "terminateds": terms, "truncateds": truncs,
            "next_obs_seq": np.stack(next_buf),
            "final_values": np.stack(finalv_buf),
            "logp": np.stack(logp_buf), "values": np.stack(val_buf),
            "next_obs": self._obs.copy(), "last_values": last_v,
        }

    def episode_metrics(self) -> dict:
        """Drain completed-episode returns collected since the last call."""
        rets, self._ep_returns = self._ep_returns, []
        return {"episodes": len(rets),
                "episode_return_mean": float(np.mean(rets)) if rets else float("nan")}

    def evaluate(self, num_episodes: int = 5) -> dict:
        """Greedy evaluation on a fresh env (same spec + kwargs as training)."""
        from ray_tpu_torch.rllib.env.envs import make_env

        env = make_env(self._env_spec, **self._env_kwargs)
        rets = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            total, done = 0.0, False
            while not done:
                a = self._greedy(obs[None])[0]
                if not self.module.spec.discrete:
                    a = a * self.module.spec.action_scale
                obs, r, term, trunc, _ = env.step(a)
                total += r
                done = term or trunc
            rets.append(total)
        return {"episode_return_mean": float(np.mean(rets))}
