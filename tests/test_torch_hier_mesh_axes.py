"""The hierarchical mesh Topology(2, 1) composed with fsdp, ep and sp
(gpt2-tiny) and with tp for llama-tiny, on 4 spawned gloo ranks, against
the JAX package's `compile_model_train` on its `build_hierarchical_mesh`
(the cases `test_torch_hier_mesh.py` leaves here so that each file runs
in about a minute; its helpers, bounds and 5-step trajectories).

With sp the port runs the ring (K1-K3's plain versions on the chunk
pairs, once a live pair of the rank's sp coordinate in step 2) against
JAX's dense attention on the same mesh: the JAX ring's shard_map fails
nested inside its fused sync's (ROADMAP queue 3). ep shards nothing of
gpt2, so its ranks compute what dp alone does, as in JAX.
"""

import pytest

import _torch_dist_workers as W
import test_torch_hier_mesh as H

FOUR = [("gpt2", {"dp": 2, "fsdp": 2}, (2, 1)),
        ("gpt2", {"dp": 2, "ep": 2}, (2, 1)),
        ("gpt2", {"dp": 2, "sp": 2}, (2, 1)),
        ("llama", {"dp": 2, "tp": 2}, (2, 1))]


@pytest.fixture(scope="module")
def jax_runs():
    return {W.hier_key(*H.run_parts(r)): H.jax_run(r) for r in FOUR}


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_runs):
    return H.ranks(tmp_path_factory, jax_runs, FOUR, 4)


@pytest.mark.parametrize("run", FOUR, ids=H.run_id)
def test_four_rank_trajectory_matches_jax(four, jax_runs, run):
    H.check(four, jax_runs, run)


def test_timed_step_equals_fused_step_on_fsdp(four):
    H.check_timed(four)
