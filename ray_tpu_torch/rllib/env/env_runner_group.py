"""EnvRunnerGroup: actor fan-out over env runners.

Parity: `rllib/env/env_runner_group.py` — remote rollout workers with
sync_weights() broadcast and fault-tolerant sampling (a dead runner is
restarted rather than failing the iteration, per the reference's
`ignore_ray_errors_on_env_runners` behavior).

Counterpart of `ray_tpu/rllib/env/env_runner_group.py`. With no remote
runners the one runner runs in-process on the learner's device. Remote
runners are CPU actors and their module runs on the CPU: the runtime
gives an actor no device ids (every worker of a node sees every card), so
a runner asked for no GPU must not touch one, and it is given
``device="cpu"`` rather than left to the port's card default.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner


@ray_tpu_torch.remote
class _RemoteEnvRunner:
    def __init__(self, env_spec, module_spec, num_envs, seed, epsilon,
                 env_kwargs, env_to_module_connector=None,
                 module_to_env_connector=None):
        self.runner = SingleAgentEnvRunner(
            env_spec, module_spec, num_envs=num_envs, seed=seed, epsilon=epsilon,
            env_kwargs=env_kwargs,
            env_to_module_connector=env_to_module_connector,
            module_to_env_connector=module_to_env_connector, device="cpu")

    def set_weights(self, params):
        self.runner.set_weights(params)
        return True

    def sample(self, num_steps, epsilon=0.0):
        batch = self.runner.sample(num_steps, epsilon=epsilon)
        batch["_metrics"] = self.runner.episode_metrics()
        return batch

    def evaluate(self, num_episodes):
        return self.runner.evaluate(num_episodes)

    def device(self):
        return str(self.runner.device)


class EnvRunnerGroup:
    """num_runners == 0 → a single in-process runner on `device` (reference
    local-worker mode); otherwise N CPU runner actors sampled in parallel."""

    def __init__(self, env_spec, module_spec, *, num_runners: int = 0,
                 num_envs_per_runner: int = 1, seed: int = 0,
                 epsilon: Optional[float] = None,
                 env_kwargs: Optional[dict] = None,
                 env_to_module_connector=None,
                 module_to_env_connector=None, device=None):
        self._env_spec = env_spec
        self._module_spec = module_spec
        self._num_envs = num_envs_per_runner
        self._seed = seed
        self._epsilon = epsilon
        self._env_kwargs = dict(env_kwargs or {})
        self._e2m = env_to_module_connector
        self._m2e = module_to_env_connector
        self.num_runners = num_runners
        if num_runners == 0:
            self.local = SingleAgentEnvRunner(
                env_spec, module_spec, num_envs=num_envs_per_runner, seed=seed,
                epsilon=epsilon, env_kwargs=self._env_kwargs,
                env_to_module_connector=env_to_module_connector,
                module_to_env_connector=module_to_env_connector,
                device=device)
            self.actors: List = []
        else:
            self.local = None
            self.actors = [self._make_actor(i) for i in range(num_runners)]

    def _make_actor(self, i: int):
        return _RemoteEnvRunner.options(max_restarts=2).remote(
            self._env_spec, self._module_spec, self._num_envs,
            self._seed + 1000 * (i + 1), self._epsilon, self._env_kwargs,
            self._e2m, self._m2e)

    def sync_weights(self, params) -> None:
        if self.local is not None:
            self.local.set_weights(params)
        else:
            ray_tpu_torch.get([a.set_weights.remote(params)
                               for a in self.actors])

    def sample(self, num_steps_per_runner: int, epsilon: float = 0.0
               ) -> List[Dict[str, np.ndarray]]:
        """One rollout fragment per runner; failed runners are replaced and
        their fragment skipped this iteration."""
        if self.local is not None:
            batch = self.local.sample(num_steps_per_runner, epsilon=epsilon)
            batch["_metrics"] = self.local.episode_metrics()
            return [batch]
        refs = [a.sample.remote(num_steps_per_runner, epsilon) for a in self.actors]
        out = []
        for i, ref in enumerate(refs):
            try:
                out.append(ray_tpu_torch.get(ref, timeout=120))
            except Exception:
                self.actors[i] = self._make_actor(i)
        return out

    def evaluate(self, num_episodes: int = 5) -> dict:
        if self.local is not None:
            return self.local.evaluate(num_episodes)
        return ray_tpu_torch.get(self.actors[0].evaluate.remote(num_episodes))

    def stop(self) -> None:
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
