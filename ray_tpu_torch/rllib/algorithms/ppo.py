"""PPO: clipped-surrogate policy optimization with GAE.

Parity: `rllib/algorithms/ppo/` (ppo.py, ppo_learner.py, default configs) —
the loss math follows the reference's torch learner
(`rllib/algorithms/ppo/torch/ppo_torch_learner.py`): clip objective, value
clipping, entropy bonus, GAE(λ).

Counterpart of `ray_tpu/rllib/algorithms/ppo.py`. GAE's reverse
`lax.scan` is a reverse loop over T on the learner's device; a fragment
crosses to the device once, and each minibatch is an index into it. The
minibatch permutation stays numpy (`default_rng(seed + iteration)`), so an
update is comparable across the two packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner


def compute_gae(rewards, values, dones, last_values, gamma, lam):
    """[T, N] tensors → (advantages, value_targets), a reverse loop over
    time (reference: `rllib/evaluation/postprocessing.py`
    compute_advantages)."""
    next_v, adv = last_values, torch.zeros_like(last_values)
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        r, v, d = rewards[t], values[t], dones[t]
        delta = r + gamma * next_v * (1 - d) - v
        adv = delta + gamma * lam * (1 - d) * adv
        advs[t] = adv
        next_v = v
    advs = torch.stack(advs)
    return advs, advs + values


class PPOLearner(Learner):
    def __init__(self, spec, cfg: "PPOConfig"):
        self.cfg = cfg
        super().__init__(spec, lr=cfg.lr, grad_clip=cfg.grad_clip,
                         seed=cfg.seed, device=cfg.device)

    def loss(self, params, batch, gen) -> Tuple[torch.Tensor, dict]:
        c = self.cfg
        dist = self.module.dist(params, batch["obs"])
        logp = dist.log_prob(batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # the population std, as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - c.clip_param, 1 + c.clip_param) * adv
        ).mean()
        v = self.module.value(params, batch["obs"])
        v_clipped = batch["values"] + torch.clamp(
            v - batch["values"], -c.vf_clip_param, c.vf_clip_param)
        vf_loss = torch.maximum((v - batch["value_targets"]) ** 2,
                                (v_clipped - batch["value_targets"]) ** 2
                                ).mean()
        entropy = dist.entropy().mean()
        total = pg + c.vf_loss_coeff * vf_loss - c.entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_kl": (batch["logp"] - logp).mean()}


class PPO(Algorithm):
    def _build_learner(self):
        return PPOLearner(self.module_spec, self.config)

    def training_step(self) -> dict:
        c = self.config
        self.env_runner_group.sync_weights(self.learner.get_weights())
        fragments = self.env_runner_group.sample(c.rollout_fragment_length)
        if not fragments:
            # every remote runner failed this iteration; they've been
            # replaced — skip the update rather than crash
            return {"num_failed_sample_rounds": 1}
        ep_metrics = [f.pop("_metrics") for f in fragments]

        # concatenate runner fragments along the env axis, compute GAE, flatten
        cat = {k: np.concatenate([f[k] for f in fragments], axis=1)
               for k in fragments[0] if k not in ("next_obs", "last_values")}
        cat["last_values"] = np.concatenate(
            [f["last_values"] for f in fragments])
        rng = np.random.default_rng(c.seed + self.iteration)
        metrics = self._ppo_update_on_fragment(self.learner, cat, rng)
        metrics.update(self._episode_metrics(ep_metrics))
        return metrics

    def _ppo_update_on_fragment(self, learner, frag: dict, rng) -> dict:
        """GAE (truncation-aware) + minibatch epochs on one [T, N]
        fragment. Bootstrap through time-limit truncation: fold γV(final_obs)
        into the reward at truncated (non-terminated) steps, then treat the
        step as done — an exact rewrite of the truncation-aware GAE."""
        c = self.config
        dev = learner.device
        boot = frag["truncateds"] & ~frag["terminateds"]
        rewards = frag["rewards"] + c.gamma * frag["final_values"] * boot
        on = lambda x: torch.tensor(np.asarray(x), device=dev)
        advs, targets = compute_gae(
            on(rewards), on(frag["values"]),
            on(frag["dones"].astype(np.float32)), on(frag["last_values"]),
            c.gamma, c.lambda_)
        T, N = frag["rewards"].shape
        flat = lambda x: x.reshape(T * N, *x.shape[2:])
        batch = {"obs": flat(on(frag["obs"])),
                 "actions": flat(on(frag["actions"])),
                 "logp": flat(on(frag["logp"])),
                 "values": flat(on(frag["values"])),
                 "advantages": flat(advs), "value_targets": flat(targets)}
        self._timesteps += T * N
        n = batch["obs"].shape[0]
        mb = min(c.minibatch_size, n)
        metrics: Dict[str, float] = {}
        for _ in range(c.num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            for st in range(0, n - mb + 1, mb):
                idx = perm[st:st + mb]
                metrics = learner.update({k: v[idx]
                                          for k, v in batch.items()})
        return metrics


class PPOConfig(AlgorithmConfig):
    algo_class = PPO

    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.lambda_ = 0.95
        self.num_epochs = 4
        self.minibatch_size = 128
