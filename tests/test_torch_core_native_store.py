"""Native C++ arena store: allocator/table semantics + runtime integration.

The port's mirror of `tests/test_native_store.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Counterpart of the reference's plasma tests
(`src/ray/object_manager/plasma/` + `python/ray/tests/test_object_store*`).
"""

import os

import numpy as np
import pytest

from ray_tpu_torch.core.native_store import (Arena, ArenaFullError, ArenaError,
                                       ObjectExistsError, native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")


@pytest.fixture
def arena():
    name = f"rtpt_test_{os.getpid()}_{os.urandom(3).hex()}"
    a = Arena.create(name, 1 << 20)
    yield a
    a.close(unlink=True)


def test_create_seal_get_roundtrip(arena):
    oid = os.urandom(16)
    payload = os.urandom(4096)
    buf = arena.create_buffer(oid, len(payload))
    buf[:] = payload
    arena.seal(oid)
    assert bytes(arena.get(oid)) == payload
    arena.release(oid)


def test_get_unsealed_raises(arena):
    oid = os.urandom(16)
    arena.create_buffer(oid, 64)
    with pytest.raises(ArenaError, match="not sealed"):
        arena.get(oid)


def test_duplicate_create_raises(arena):
    oid = os.urandom(16)
    arena.create_buffer(oid, 64)
    with pytest.raises(ObjectExistsError):
        arena.create_buffer(oid, 64)


def test_cross_process_visibility(arena):
    """Another handle (same mapping path a different process would take)
    sees sealed objects zero-copy."""
    oid = os.urandom(16)
    buf = arena.create_buffer(oid, 5)
    buf[:] = b"hello"
    arena.seal(oid)
    other = Arena.attach(arena.name)
    try:
        assert bytes(other.get(oid)) == b"hello"
        other.release(oid)
    finally:
        other.close()


def test_full_then_delete_reuses_space(arena):
    oids = []
    with pytest.raises(ArenaFullError):
        for i in range(1000):
            oid = i.to_bytes(16, "big")
            arena.create_buffer(oid, 128 * 1024)
            arena.seal(oid)
            oids.append(oid)
    for oid in oids:
        assert arena.delete(oid)
    # coalescing must yield one big block again
    arena.create_buffer(os.urandom(16), 512 * 1024)


def test_pinned_objects_not_evictable(arena):
    a_id, b_id = os.urandom(16), os.urandom(16)
    for oid in (a_id, b_id):
        arena.create_buffer(oid, 64 * 1024)
        arena.seal(oid)
    arena.get(a_id)  # pins a
    cands = arena.evict_candidates(1 << 20, max_out=16)
    assert a_id not in cands
    assert b_id in cands
    assert not arena.delete(a_id, force=False)   # pinned
    arena.release(a_id)
    assert arena.delete(a_id, force=False)


def test_lru_eviction_order(arena):
    ids = [i.to_bytes(16, "big") for i in range(4)]
    for oid in ids:
        arena.create_buffer(oid, 32 * 1024)
        arena.seal(oid)
    # touch 0 and 1 so 2 is the LRU
    arena.get(ids[0]); arena.release(ids[0])
    arena.get(ids[1]); arena.release(ids[1])
    cands = arena.evict_candidates(32 * 1024, max_out=1)
    assert cands == [ids[2]]


def test_runtime_puts_land_in_arena():
    """End-to-end: a cluster's large objects go through the native arena."""
    import ray_tpu_torch

    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=2)
        big = np.arange(1 << 18, dtype=np.int64)  # 2 MiB, above inline
        ref = ray_tpu_torch.put(big)
        from ray_tpu_torch.core.api import _global_client

        meta = _global_client().local_metas[ref.id]
        assert meta.kind == "arena", meta.kind

        @ray_tpu_torch.remote
        def total(x):
            return int(x.sum())

        assert ray_tpu_torch.get(total.remote(ref)) == int(big.sum())
    finally:
        ray_tpu_torch.shutdown()


def test_head_spills_arena_at_watermark():
    """Fill a small arena past the watermark; old objects spill to disk and
    remain readable through the meta-refresh path."""
    import ray_tpu_torch

    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=2,
                           object_store_bytes=16 << 20)
        refs = [ray_tpu_torch.put(np.full(1 << 16, i, np.int64)) for i in range(40)]
        # ~20 MB total > 16 MB arena: early objects must have been spilled
        vals = ray_tpu_torch.get(refs)
        for i, v in enumerate(vals):
            assert v[0] == i and v.shape == (1 << 16,)
    finally:
        ray_tpu_torch.shutdown()
