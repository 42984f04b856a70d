"""ray_tpu_torch.rllib — reinforcement learning on the port's runtime.

Capability parity with the reference's RLlib (`rllib/` — Algorithm/
AlgorithmConfig, EnvRunnerGroup actor rollouts, Learner updates): rollouts
run on CPU env-runner actors (or in-process on the learner's device); the
learner's update runs on the card unless asked for the CPU.

Counterpart of `ray_tpu.rllib`, ported so far: the envs, connectors,
RLModule, the Learner, the env runners, Algorithm/AlgorithmConfig and PPO.
The other algorithms, multi-agent training and the external env are
ROADMAP item 14b: naming one raises `NotImplementedError`.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.rl_module import (ModuleSpec, RLModule,
                                                spec_from_env)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.envs import (Box, CartPole, Discrete, Env,
                                          Pendulum, VectorEnv, make_env,
                                          register_env)

# the JAX package's names that ROADMAP item 14b ports
NOT_PORTED = (
    "BC", "BCConfig", "DQN", "DQNConfig", "SAC", "SACConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "MARWIL", "MARWILConfig", "CQL",
    "CQLConfig", "IQL", "IQLConfig", "DreamerV3", "DreamerV3Config",
    "MultiAgentEnv", "MultiAgentEnvRunner", "TargetMatch")

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
    "Box", "CartPole", "Discrete", "Env", "Pendulum",
    "VectorEnv", "make_env", "register_env", "SingleAgentEnvRunner",
    "EnvRunnerGroup", "ModuleSpec", "RLModule", "spec_from_env",
]


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.rllib.{name} is not ported yet (ROADMAP item "
            f"14b: the other algorithms, multi-agent, the external env)")
    raise AttributeError(
        f"module 'ray_tpu_torch.rllib' has no attribute {name!r}")
