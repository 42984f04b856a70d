"""RLlib's core and PPO in the port (`ray_tpu_torch.rllib`) against the JAX
package's.

- Bit for bit (numpy on both sides): CartPole and Pendulum under one seed
  and one action sequence, the vector env's autoreset, the connectors.
- From the JAX package's params carried in by `params_from_numpy`, in f32
  on the CPU: `RLModule.value`, `pi_out` and each distribution's
  `log_prob`, `entropy`, `kl` and mode within atol 1e-5, rtol 1e-4 (the
  trajectory tolerance); GAE within 1e-6; PPO's loss and its metrics
  within 1e-5 / 1e-4; one `_ppo_update_on_fragment` (4 epochs over the
  numpy permutation) within `UPDATE_ATOL`; greedy rollouts take the same
  actions. Sampling draws from other streams than `jax.random`, so it is
  held to its statistics.
- Mirrors of `tests/test_rllib.py`'s PPO, env, connector, checkpoint and
  Tune cases on the port (`device="cpu"`), and what is not ported yet:
  multi-agent and the learner's mesh raise, naming ROADMAP item 14b.

Needs no card.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import PPOConfig as JPPOConfig
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.env import env_runner as jrunner
from ray_tpu.rllib.env import envs as jenvs
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib import (CartPole, Pendulum, PPOConfig, VectorEnv,
                                 make_env, register_env, spec_from_env)
from ray_tpu_torch.rllib import connectors as pconn
from ray_tpu_torch.rllib.algorithms import ppo as pppo
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.env import env_runner as prunner

ATOL, RTOL = 1e-5, 1e-4
# one PPO update on a fragment (16 Adam steps from the same params and
# minibatches): the largest |Δ| of any parameter. f32 rounding alone stays
# within a few ulps of weights of order 1 (1e-7); Adam's first steps move
# each weight by about lr·sign(g), so a gradient near 0 whose sign the
# rounding flips would move its weight by up to 2·lr = 6e-4, and a wrong
# term anywhere moves many by more than 1e-6.
UPDATE_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # width-64 MLPs: one thread is faster alone, and beside other busy
    # processes the default thread pool makes them many times slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=8)
    yield info
    ray_tpu_torch.shutdown()


def _cfg(**training):
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
            .training(**{"minibatch_size": 32, "num_epochs": 1, **training})
            .learners(device="cpu"))


def _close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# -------------------------------------------------- envs and connectors
@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_envs_bit_equal_to_jax(name):
    rng = np.random.default_rng(0)
    je, pe = jenvs.make_env(name), make_env(name)
    jo, _ = je.reset(seed=3)
    po, _ = pe.reset(seed=3)
    assert jo.tobytes() == po.tobytes()
    for _ in range(250):
        a = (int(rng.integers(2)) if name.startswith("CartPole")
             else rng.uniform(-2, 2, (1,)).astype(np.float32))
        jr, pr = je.step(a), pe.step(a)
        assert jr[0].tobytes() == pr[0].tobytes() and jr[1:4] == pr[1:4]
        if jr[2] or jr[3]:
            seed = int(rng.integers(1000))
            assert je.reset(seed=seed)[0].tobytes() == \
                pe.reset(seed=seed)[0].tobytes()
    # the vector env's autoreset, final obs and episode returns
    jv, pv = jenvs.VectorEnv(name, 3, seed=5), VectorEnv(name, 3, seed=5)
    assert jv.start().tobytes() == pv.start().tobytes()
    for _ in range(120):
        a = (rng.integers(0, 2, 3) if name.startswith("CartPole")
             else rng.uniform(-2, 2, (3, 1)).astype(np.float32))
        for x, y in zip(jv.step(a), pv.step(a)):
            assert x.tobytes() == y.tobytes()


def test_connectors_bit_equal_to_jax():
    def pipe(m):
        return m.build_pipeline(lambda: [m.ClipObs(-4, 4), m.MeanStdObs(),
                                         m.FrameStackObs(k=3)])

    jp, pp = pipe(jconn), pipe(pconn)
    ja, pa = jconn.ClipActions(-1, 1), pconn.ClipActions(-1, 1)
    rng = np.random.default_rng(0)
    for _ in range(12):
        b = rng.normal(1.0, 3.0, (8, 4)).astype(np.float32)
        assert jp(b).tobytes() == pp(b).tobytes()
        assert jp.transform(b).tobytes() == pp.transform(b).tobytes()
        assert ja(b).tobytes() == pa(b).tobytes()
    js, ps = jp.get_state(), pp.get_state()
    assert js[1]["count"] == ps[1]["count"]
    assert js[1]["m2"].tobytes() == ps[1]["m2"].tobytes()


# -------------------------------------------------------------- RLModule
SPECS = {
    "discrete": dict(obs_dim=4, action_dim=3, discrete=True),
    "gaussian": dict(obs_dim=3, action_dim=2, discrete=False),
    "squashed": dict(obs_dim=3, action_dim=2, discrete=False, squashed=True),
}


def _jax_params(spec, seed):
    return jax.tree.map(np.asarray, jrl.RLModule(
        jrl.ModuleSpec(**spec)).init(jax.random.key(seed)))


def _actions(kind, rng, n):
    if kind == "discrete":
        return rng.integers(0, 3, n).astype(np.int32)
    a = rng.uniform(-0.95, 0.95, (n, 2)).astype(np.float32)
    return a if kind == "squashed" else 2 * a


@pytest.mark.parametrize("kind", list(SPECS))
def test_rl_module_matches_jax(kind):
    spec = SPECS[kind]
    jm, pm = jrl.RLModule(jrl.ModuleSpec(**spec)), prl.RLModule(
        prl.ModuleSpec(**spec))
    jp, jq = _jax_params(spec, 0), _jax_params(spec, 1)
    if kind == "gaussian":
        jp["log_std"] = np.array([-0.3, 0.2], np.float32)
    pp = prl.params_from_numpy(jp, "cpu")
    pq = prl.params_from_numpy(jq, "cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(
        prl.params_to_numpy(pp))
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, spec["obs_dim"])).astype(np.float32)
    act = _actions(kind, rng, 64)
    o, a = torch.from_numpy(obs), torch.from_numpy(act)
    _close(pm.value(pp, o), jm.value(jp, obs))
    _close(pm.pi_out(pp, o), jm.pi_out(jp, obs))
    jd, pd = jm.dist(jp, obs), pm.dist(pp, o)
    _close(pd.log_prob(a), jd.log_prob(act))
    _close(pd.entropy(), jd.entropy())
    _close(pd.mode(), jd.mode())
    if kind != "squashed":     # the JAX package gives SquashedGaussian no kl
        _close(pd.kl(pm.dist(pq, o)), jd.kl(jm.dist(jq, obs)))
    if kind == "squashed":
        _close(torch.stack(pm.q_values(pp, o, a)),
               np.stack(jm.q_values(jp, obs, act)))


def test_sampling_statistics():
    """Draws come from a torch.Generator, not jax.random: each
    distribution is held to its statistics."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.5, -1.0, 1.5]]).expand(20000, 3)
    d = prl.Categorical(logits)
    freq = torch.bincount(d.sample(gen), minlength=3).float() / 20000
    _close(freq, torch.softmax(logits[0], -1), atol=0.015, rtol=0)
    g = prl.DiagGaussian(torch.full((20000, 2), 0.7),
                         torch.tensor([-0.5, 0.3]))
    x = g.sample(gen)
    _close(x.mean(0), [0.7, 0.7], atol=0.03, rtol=0)
    _close(x.std(0), np.exp([-0.5, 0.3]), atol=0.03, rtol=0)
    # the same generator state draws the same samples
    s1 = d.sample(torch.Generator().manual_seed(5))
    assert torch.equal(s1, d.sample(torch.Generator().manual_seed(5)))


def test_squashed_gaussian_logp():
    d = prl.SquashedGaussian(torch.zeros((4, 2)), torch.full((4, 2), -0.5))
    a, logp = d.sample_with_logp(torch.Generator().manual_seed(0))
    assert (a.abs() <= 1.0).all()
    _close(d.log_prob(a), logp, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ GAE, PPO
def _gae_inputs(T=7, N=3):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            (rng.random((T, N)) < 0.2).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32))


def test_gae_matches_jax():
    args = _gae_inputs()
    jadv, jtgt = jppo.compute_gae(*args, 0.99, 0.95)
    padv, ptgt = pppo.compute_gae(*map(torch.from_numpy, args), 0.99, 0.95)
    _close(padv, jadv, atol=1e-6, rtol=0)
    _close(ptgt, jtgt, atol=1e-6, rtol=0)


def test_gae_matches_reference_impl():
    rewards, values, dones, last_v = _gae_inputs(5, 2)
    adv, tgt = pppo.compute_gae(*map(torch.from_numpy,
                                     (rewards, values, dones, last_v)),
                                0.99, 0.95)
    expect = np.zeros((5, 2))
    gae = np.zeros(2)
    next_v = last_v
    for t in reversed(range(5)):
        delta = rewards[t] + 0.99 * next_v * (1 - dones[t]) - values[t]
        gae = delta + 0.99 * 0.95 * (1 - dones[t]) * gae
        expect[t] = gae
        next_v = values[t]
    _close(adv, expect)
    _close(tgt, expect + values)


def _ppo_batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "values": rng.normal(size=n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


def _pair(**training):
    """A JAX PPO and the port's, both with the JAX package's init."""
    def setup(c):
        return (c.environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=64)
                .training(**{"num_epochs": 4, "minibatch_size": 64,
                             **training})
                .debugging(seed=0))

    jalgo = setup(JPPOConfig()).build()
    palgo = setup(PPOConfig().learners(device="cpu")).build()
    palgo.learner.set_weights(jalgo.learner.get_weights())
    return jalgo, palgo


def test_ppo_loss_matches_jax():
    jalgo, palgo = _pair(entropy_coeff=0.01, vf_clip_param=0.5)
    batch = _ppo_batch()
    jl, jm = jalgo.learner.loss(jalgo.learner.params,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                None)
    pl, pm = palgo.learner.loss(
        palgo.learner.params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    _close(pl, jl)
    assert set(pm) == set(jm)
    for k in jm:
        _close(pm[k], jm[k])
    jalgo.stop(); palgo.stop()


def test_ppo_update_on_fragment_matches_jax():
    jalgo, palgo = _pair()
    frag = jalgo.env_runner_group.sample(64)[0]
    frag.pop("_metrics")
    frag.pop("next_obs")
    jm = jalgo._ppo_update_on_fragment(jalgo.learner, dict(frag),
                                       np.random.default_rng(3))
    pm = palgo._ppo_update_on_fragment(palgo.learner, dict(frag),
                                       np.random.default_rng(3))
    for k in jm:
        _close(pm[k], jm[k], atol=1e-4, rtol=1e-3)
    jw, pw = jalgo.learner.get_weights(), palgo.learner.get_weights()
    worst = max(float(np.max(np.abs(a - b))) for a, b in zip(
        jax.tree.leaves(jw), jax.tree.leaves(pw)))
    print(f"one PPO update: max |param - JAX's| {worst:.3e}")
    assert worst <= UPDATE_ATOL, worst
    jalgo.stop(); palgo.stop()


def test_greedy_rollouts_match_jax():
    spec = SPECS["discrete"] | {"obs_dim": 4, "action_dim": 2}
    params = _jax_params(spec, 4)
    jr = jrunner.SingleAgentEnvRunner("CartPole-v1", jrl.ModuleSpec(**spec),
                                      num_envs=3, seed=2, explore=False)
    pr = prunner.SingleAgentEnvRunner("CartPole-v1", prl.ModuleSpec(**spec),
                                      num_envs=3, seed=2, explore=False,
                                      device="cpu")
    jr.set_weights(params)
    pr.set_weights(params)
    jb, pb = jr.sample(60), pr.sample(60)
    assert np.array_equal(jb["actions"], pb["actions"])
    for k in ("obs", "rewards", "dones", "next_obs"):
        assert jb[k].tobytes() == pb[k].tobytes(), k
    for k in ("logp", "values", "final_values", "last_values"):
        _close(pb[k], jb[k])
    assert pr.evaluate(2) == jr.evaluate(2)


# ------------------------------------------------ mirrors of test_rllib.py
def test_cartpole_env_protocol():
    env = CartPole()
    obs, info = env.reset(seed=0)
    assert obs.shape == (4,)
    obs2, r, term, trunc, _ = env.step(env.action_space.sample(
        np.random.default_rng(0)))
    assert r == 1.0 and not trunc
    assert obs2.shape == (4,)


def test_vector_env_autoreset():
    vec = VectorEnv("CartPole-v1", 3, seed=0)
    obs = vec.reset()
    assert obs.shape == (3, 4)
    done_seen, ep_ret_seen, final_obs_differs = False, False, False
    for _ in range(300):
        obs, r, term, trunc, final_obs, ep_ret = vec.step(
            np.random.default_rng(1).integers(0, 2, 3))
        done = term | trunc
        if done.any():
            done_seen = True
            i = int(np.argmax(done))
            if not np.allclose(final_obs[i], obs[i]):
                final_obs_differs = True
        if not np.isnan(ep_ret).all():
            ep_ret_seen = True
    assert done_seen and ep_ret_seen and final_obs_differs


def test_register_env():
    register_env("MyCartPole", lambda: CartPole(max_episode_steps=10))
    env = make_env("MyCartPole")
    env.reset(seed=0)
    for _ in range(11):
        _, _, term, trunc, _ = env.step(0)
        if term or trunc:
            break
    assert term or trunc


def test_ppo_learns_cartpole():
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=128)
            .training(num_epochs=4, minibatch_size=256, lr=3e-4)
            .learners(device="cpu")
            .debugging(seed=0)
            .build())
    first = algo.train()
    for _ in range(12):
        result = algo.train()
    assert result["episode_return_mean"] > 60, result
    assert result["episode_return_mean"] > first.get("episode_return_mean", 22)
    algo.stop()


def test_ppo_remote_env_runners(cluster):
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(num_epochs=2, minibatch_size=64)
            .learners(device="cpu")
            .build())
    r = algo.train()
    assert r["num_env_steps_sampled_lifetime"] == 32 * 4
    r = algo.train()
    assert r["training_iteration"] == 2
    # remote runners are CPU actors, their module on the CPU
    assert ray_tpu_torch.get([a.device.remote() for a in
                              algo.env_runner_group.actors],
                             timeout=60) == ["cpu", "cpu"]
    algo.stop()


def test_algorithm_checkpoint_roundtrip(tmp_path):
    algo = _cfg().build()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ckpt"))
    w0 = algo.get_policy_weights()

    algo2 = _cfg().build()
    algo2.restore(ckpt)
    w1 = algo2.get_policy_weights()
    np.testing.assert_allclose(w0["pi"][0]["w"], w1["pi"][0]["w"])
    assert algo2.iteration == 1
    # the pickle holds numpy (and ints) only, no tensor
    with open(tmp_path / "ckpt" / "algorithm_state.pkl", "rb") as f:
        state = pickle.load(f)
    leaves = jax.tree.leaves(state)
    assert leaves and all(isinstance(x, (np.ndarray, int)) for x in leaves)
    # Adam's state comes back too
    st, st2 = algo.learner.get_state(), algo2.learner.get_state()
    assert st2["opt_state"]["count"] == st["opt_state"]["count"] > 0
    for k in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(st["opt_state"][k]),
                        jax.tree.leaves(st2["opt_state"][k])):
            assert a.tobytes() == b.tobytes()
    algo.stop(); algo2.stop()


def test_as_trainable_with_tune(cluster, tmp_path):
    from ray_tpu_torch.rllib import PPO
    from ray_tpu_torch.train.config import RunConfig
    from ray_tpu_torch.tune.schedulers import ASHAScheduler
    from ray_tpu_torch.tune.search import grid_search
    from ray_tpu_torch.tune.tuner import TuneConfig, Tuner

    tuner = Tuner(
        PPO.as_trainable(_cfg()),
        param_space={"lr": grid_search([1e-3, 3e-4])},
        tune_config=TuneConfig(
            metric="total_loss", mode="min", num_samples=1,
            scheduler=ASHAScheduler(metric="total_loss", mode="min", max_t=2)),
        run_config=RunConfig(name="rllib-tune", storage_path=str(tmp_path)))
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.error is None and "total_loss" in best.metrics
    assert len(grid) == 2


def test_env_config_reaches_runners():
    algo = (PPOConfig()
            .environment("CartPole-v1", env_config={"max_episode_steps": 7})
            .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=30)
            .training(minibatch_size=32, num_epochs=1)
            .learners(device="cpu").build())
    r = algo.train()
    assert abs(r["episode_return_mean"] - 7.0) < 1e-6, r
    algo.stop()


def test_spec_from_env_scaling():
    spec = spec_from_env(Pendulum())
    assert not spec.discrete and spec.action_scale == 2.0
    spec = spec_from_env(CartPole())
    assert spec.discrete and spec.action_dim == 2


def test_connector_pipeline_units():
    ms = pconn.MeanStdObs()
    rng = np.random.default_rng(0)
    for _ in range(20):
        ms(rng.normal(5.0, 3.0, size=(32, 4)))
    out = ms(rng.normal(5.0, 3.0, size=(1000, 4)))
    assert abs(out.mean()) < 0.2 and abs(out.std() - 1.0) < 0.2
    before = ms.count
    ms.transform(np.zeros((8, 4)))
    assert ms.count == before
    ms2 = pconn.MeanStdObs()
    ms2.set_state(ms.get_state())
    np.testing.assert_allclose(ms2.transform(np.zeros((2, 4))),
                               ms.transform(np.zeros((2, 4))), atol=1e-6)
    fs = pconn.FrameStackObs(k=3)
    a = fs(np.ones((2, 4)))
    assert a.shape == (2, 12)
    b = fs(np.full((2, 4), 2.0))
    assert b[0, -1] == 2.0 and b[0, 0] == 0.0
    p = pconn.build_pipeline(lambda: [pconn.ClipObs(-1, 1),
                                      pconn.MeanStdObs()])
    assert p is not None and len(p.connectors) == 2
    assert pconn.build_pipeline(None) is None


def test_ppo_with_connectors_trains():
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=4,
                         rollout_fragment_length=64,
                         env_to_module_connector=lambda: [pconn.MeanStdObs()])
            .training(minibatch_size=64, num_epochs=2)
            .learners(device="cpu")
            .build())
    r = {}
    for _ in range(3):
        r = algo.train()
    assert np.isfinite(r["policy_loss"])
    assert algo.env_runner_group.local.env_to_module is not None
    assert algo.env_runner_group.local.env_to_module.connectors[0].count > 0
    algo.stop()


# ------------------------------------------ the device, what is not ported
def test_learner_runs_on_the_card_unless_asked(monkeypatch):
    """No device means the card: without one the build raises rather than
    falling back to the CPU. The in-process runner shares the learner's
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (PPOConfig().environment("CartPole-v1")
         .env_runners(rollout_fragment_length=8).build())
    algo = _cfg().build()
    assert algo.learner.device.type == "cpu"
    assert algo.env_runner_group.local.device.type == "cpu"
    algo.stop()


def test_not_ported_yet_raises_naming_item_14b():
    with pytest.raises(NotImplementedError, match="14b"):
        PPOConfig().multi_agent(policies={"p0": None})
    with pytest.raises(NotImplementedError, match="14b"):
        PPOConfig().learners(mesh_devices=8)
    with pytest.raises(NotImplementedError, match="14b"):
        _cfg(mesh_devices=8).build()
    with pytest.raises(NotImplementedError, match="14b"):
        _cfg(policies={"p0": None}).build()
    for name in ("DQNConfig", "SAC", "IMPALA", "MultiAgentEnv"):
        with pytest.raises(NotImplementedError, match="14b"):
            getattr(rllib, name)
