"""AlgorithmConfig: the fluent builder the reference uses everywhere.

Parity: `rllib/algorithms/algorithm_config.py` — `.environment()`,
`.env_runners()`, `.training()`, `.learners()`, `.evaluation()`, `.build()`.

Counterpart of `ray_tpu/rllib/algorithms/algorithm_config.py`, with a
`device` for the learner (None: the card, the port's contract). Its
`multi_agent()` and `learners(mesh_devices=...)` raise: multi-agent
training and the learner's data parallel are ROADMAP item 14b.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Tuple


class AlgorithmConfig:
    algo_class = None  # set by subclasses (PPOConfig → PPO, ...)

    def __init__(self):
        # environment
        self.env: Any = "CartPole-v1"
        self.env_kwargs: dict = {}
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 128
        self.env_to_module_connector = None   # factory -> ConnectorPipeline
        self.module_to_env_connector = None
        # training (shared knobs; algo subclasses add their own)
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.grad_clip: Optional[float] = 0.5
        self.train_batch_size: int = 512
        self.hiddens: Tuple[int, ...] = (64, 64)
        self.seed: int = 0
        # learners: the learner's device (None: the card; "cpu" on purpose)
        self.device: Optional[str] = None
        # the JAX package's dp mesh; not ported (item 14b)
        self.mesh_devices: Optional[int] = None
        # evaluation
        self.evaluation_interval: int = 0
        self.evaluation_num_episodes: int = 5
        # multi-agent (reference config.multi_agent()): policy id ->
        # ModuleSpec (or None to derive from the env) + agent->policy map
        self.policies: Optional[dict] = None
        self.policy_mapping_fn: Optional[Any] = None

    # fluent setters — each returns self, mirroring the reference exactly
    def environment(self, env=None, *, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_kwargs = env_config
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector=None,
                    module_to_env_connector=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        # connector FACTORIES (reference contract): each runner builds
        # its own stateful pipeline from these
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def multi_agent(self, *, policies: Optional[dict] = None,
                    policy_mapping_fn=None):
        """Multi-agent training (the JAX package's `MultiAgentEnvRunner`
        and per-policy learners) is not ported yet."""
        raise NotImplementedError(
            "multi-agent training is not ported to ray_tpu_torch yet "
            "(ROADMAP item 14b)")

    def learners(self, *, device: Optional[str] = None,
                 mesh_devices: Optional[int] = None):
        """`device` is the learner's (None: the card). `mesh_devices`, the
        JAX package's single-controller dp mesh, is not ported: the port's
        data parallel runs one process a device."""
        if mesh_devices is not None:
            raise NotImplementedError(
                "the learner's data parallel (mesh_devices) is not ported "
                "to ray_tpu_torch yet (ROADMAP item 14b)")
        if device is not None:
            self.device = device
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_episodes: Optional[int] = None):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_episodes is not None:
            self.evaluation_num_episodes = evaluation_num_episodes
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":  # noqa: F821
        if self.algo_class is None:
            raise ValueError("use an algorithm-specific config (PPOConfig, ...)")
        return self.algo_class(self.copy())

    # Tune integration: dict-style access for param_space sweeps
    def update_from_dict(self, d: dict) -> "AlgorithmConfig":
        for k, v in d.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown config key {k!r}")
            setattr(self, k, v)
        return self
