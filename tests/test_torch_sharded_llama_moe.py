"""Sharded llama-tiny (grouped-query: its KV heads stay replicated over tp
and expand to each rank's query heads) on `dp=2,tp=2` and `fsdp=2,tp=2`,
and moe-tiny (4 experts) on `ep=4`, the experts stacked on ep: four spawned
gloo ranks against the JAX package's `compile_model_train` on the same mesh
and the port on one device, as `test_torch_sharded.py` holds gpt2-tiny."""

import pytest

import test_torch_sharded as S

FOUR = [("llama", {"dp": 2, "tp": 2}), ("llama", {"fsdp": 2, "tp": 2}),
        ("moe", {"ep": 4})]


@pytest.fixture(scope="module")
def jax_runs():
    return {S._key(n, c): S._jax_run(n, c) for n, c in FOUR}


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_runs):
    return S.four_ranks(tmp_path_factory, jax_runs, FOUR, False)


@pytest.mark.parametrize("name,config", FOUR,
                         ids=[S.run_id(n, c) for n, c in FOUR])
def test_four_rank_trajectory_matches_jax_and_one_device(four, jax_runs,
                                                         name, config):
    S.check_four(four, jax_runs, name, config)
