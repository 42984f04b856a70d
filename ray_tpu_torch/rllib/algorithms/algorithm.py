"""Algorithm: the top-level train loop object.

Parity: `rllib/algorithms/algorithm.py` — `train()` returns a result dict,
`save()/restore()` checkpoint the component tree (reference Checkpointable
mixin), `evaluate()` runs greedy episodes, and the object is Tune-trainable
via `as_trainable()`.

Counterpart of `ray_tpu/rllib/algorithms/algorithm.py`. The learner runs on
`config.device` (None: the card; the port never falls back to the CPU);
the checkpoint's pickle holds numpy only. Multi-agent training and the
learner's dp mesh raise (ROADMAP item 14b).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import ModuleSpec, spec_from_env
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.envs import make_env


class Algorithm:
    learner_cls = None       # set by subclasses
    needs_epsilon = False    # DQN-style exploration

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.policies:
            self._init_multi_agent()
        if config.mesh_devices:
            raise NotImplementedError(
                "the learner's data parallel (mesh_devices) is not ported "
                "to ray_tpu_torch yet (ROADMAP item 14b)")
        probe = make_env(config.env, **config.env_kwargs)
        self.module_spec = self._module_spec(probe)
        self.learner = self._build_learner()
        self.env_runner_group = EnvRunnerGroup(
            config.env, self.module_spec,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_env_runner,
            seed=config.seed,
            epsilon=0.0 if self.needs_epsilon else None,
            env_kwargs=config.env_kwargs,
            env_to_module_connector=config.env_to_module_connector,
            module_to_env_connector=config.module_to_env_connector,
            device=self.learner.device)
        self.env_runner_group.sync_weights(self.learner.get_weights())
        self.iteration = 0
        self._timesteps = 0

    def _init_multi_agent(self) -> None:
        raise NotImplementedError(
            "multi-agent training is not ported to ray_tpu_torch yet "
            "(ROADMAP item 14b)")

    # hooks -----------------------------------------------------------------
    def _module_spec(self, env) -> ModuleSpec:
        spec = spec_from_env(env)
        return ModuleSpec(**{**spec.__dict__, "hiddens": tuple(self.config.hiddens)})

    def _build_learner(self):
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    # public API ------------------------------------------------------------
    def train(self) -> dict:
        t0 = time.time()
        metrics = self.training_step()
        self.iteration += 1
        result = {"training_iteration": self.iteration,
                  "num_env_steps_sampled_lifetime": self._timesteps,
                  "time_this_iter_s": time.time() - t0, **metrics}
        if (self.config.evaluation_interval
                and self.iteration % self.config.evaluation_interval == 0):
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> dict:
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return self.env_runner_group.evaluate(self.config.evaluation_num_episodes)

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        state = {"iteration": self.iteration, "timesteps": self._timesteps,
                 "learner": self.learner.get_state()}
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self.env_runner_group.sync_weights(self.learner.get_weights())
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    def stop(self) -> None:
        self.env_runner_group.stop()

    def get_policy_weights(self, policy_id: Optional[str] = None):
        return self.learner.get_weights()

    # ----------------------------------------------------- off-policy helper
    def _off_policy_step(self, epsilon: float = 0.0) -> dict:
        """Shared DQN/SAC iteration: sample → replay.add → N updates.
        Bootstraps through time-limit truncation by storing the pre-reset
        successor obs and masking targets with `terminateds` only."""
        c = self.config
        self.env_runner_group.sync_weights(self.learner.get_weights())
        fragments = self.env_runner_group.sample(c.rollout_fragment_length,
                                                 epsilon=epsilon)
        ep_metrics = [f.pop("_metrics") for f in fragments]
        for f in fragments:
            T, N = f["rewards"].shape
            self.replay.add_batch(f["obs"], f["actions"], f["rewards"],
                                  f["terminateds"].astype(np.float32),
                                  f["next_obs_seq"])
            self._timesteps += T * N
        metrics = {}
        if self.replay.size >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iteration):
                metrics = self.learner.update(
                    self.replay.sample(c.train_batch_size))
        return {**metrics, **self._episode_metrics(ep_metrics)}

    @staticmethod
    def _episode_metrics(ep_metrics) -> dict:
        eps = [m for m in ep_metrics if m["episodes"]]
        if not eps:
            return {}
        return {"episode_return_mean": float(np.mean(
            [m["episode_return_mean"] for m in eps]))}

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig):
        """Adapter so `tune.Tuner(PPO.as_trainable(cfg), param_space=...)`
        sweeps RLlib configs (reference: Algorithms are Tune Trainables).
        The returned function follows this framework's trainable protocol:
        one `config` arg, reporting via `ray_tpu_torch.train.session.report`
        (which raises StopIteration when the scheduler stops the trial).
        The learner takes `base_config.device`: a trial without a GPU
        lease gives ``"cpu"`` there, or the card default raises where
        there is none."""

        def _train_fn(config: dict):
            from ray_tpu_torch.train import session

            algo = cls(base_config.copy().update_from_dict(config))
            try:
                while True:
                    session.report(algo.train())
            except StopIteration:
                pass
            finally:
                algo.stop()

        return _train_fn
