"""Uniform replay buffer for off-policy algorithms (DQN/SAC).

Parity: `rllib/utils/replay_buffers/` (EpisodeReplayBuffer, uniform sampling)
— numpy ring buffer on the learner host; sampled minibatches move to device
per update.

Counterpart of `ray_tpu/rllib/core/replay.py`, copied (numpy).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, discrete: bool,
                 action_dim: int = 1, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        if discrete:
            self.actions = np.zeros((capacity,), np.int32)
        else:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self.size = 0
        self._idx = 0

    def add_batch(self, obs, actions, rewards, dones, next_obs) -> None:
        """Add [T, N, ...] rollout leaves transition-by-transition. next_obs
        here is obs shifted by one step with the final vector-env obs last."""
        T, N = rewards.shape
        flat = lambda x: x.reshape(T * N, *x.shape[2:])
        for o, a, r, d, no in zip(flat(obs), flat(actions), flat(rewards),
                                  flat(dones), flat(next_obs)):
            i = self._idx
            self.obs[i], self.actions[i] = o, a
            self.rewards[i], self.dones[i], self.next_obs[i] = r, d, no
            self._idx = (i + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.size, size=batch_size)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx],
                "next_obs": self.next_obs[idx]}
