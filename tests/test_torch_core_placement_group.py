"""Placement groups: reserve bundles, run tasks inside them.

The port's mirror of `tests/test_placement_group.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import placement_group, remove_placement_group


@pytest.fixture(scope="module")
def cluster():
    try:
        yield ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=8)
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def one():
    return 1


def test_pg_reserve_and_run(cluster):
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.ready(timeout=10)
    # reservation shrinks the free pool
    assert ray_tpu_torch.available_resources()["CPU"] == 2.0
    # tasks inside the pg draw from the reservation, not the free pool
    refs = [one.options(placement_group=pg).remote() for _ in range(4)]
    assert ray_tpu_torch.get(refs, timeout=30) == [1, 1, 1, 1]
    remove_placement_group(pg)
    # release is eventually consistent: a worker's task_done may land after
    # get() returns; poll until the ledger settles
    import time

    deadline = time.monotonic() + 10
    while ray_tpu_torch.available_resources()["CPU"] != 4.0:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


def test_pg_task_after_remove_fails(cluster):
    pg = placement_group([{"CPU": 1}])
    assert pg.ready(timeout=10)
    remove_placement_group(pg)
    from ray_tpu_torch.core.exceptions import RayTpuError

    with pytest.raises(RayTpuError):
        ray_tpu_torch.get(one.options(placement_group=pg).remote(), timeout=10)


def test_pg_pending_until_capacity(cluster):
    pg1 = placement_group([{"CPU": 3}])
    assert pg1.ready(timeout=10)
    pg2 = placement_group([{"CPU": 3}])
    assert not pg2.ready(timeout=0.5)  # doesn't fit alongside pg1
    remove_placement_group(pg1)
    assert pg2.ready(timeout=10)       # becomes ready once pg1 releases
    remove_placement_group(pg2)


def test_pg_invalid_args(cluster):
    with pytest.raises(ValueError):
        placement_group([], strategy="PACK")
    with pytest.raises(ValueError):
        placement_group([{"CPU": 1}], strategy="NOT_A_STRATEGY")
