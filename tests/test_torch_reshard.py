"""`util.collective.reshard` in the port against the JAX package's, on four
spawned gloo ranks (`_torch_dist_workers.reshard_ranks`).

As `tests/test_collective.py` holds the JAX module: `reshard` from the
host, on one mesh (DTensor's redistribute) and across meshes (each rank
takes its index window) returns the array bit for bit, scalars and trees
included; `reshard_streaming` of a 512 KB leaf in 64 KB chunks keeps the
peak of live host chunks within `max_in_flight * chunk_bytes` and gives
`reshard`'s bits, from an array and from a `WindowedReader` (with a dtype
conversion). Each rank's shard is the one JAX's `reshard` puts on the
device of the same index in the same mesh.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

import _torch_dist_workers as W
from ray_tpu.util.collective import reshard as jax_reshard

X = np.arange(64, dtype=np.float32).reshape(8, 8)
BIG = np.arange(1024 * 128, dtype=np.float32).reshape(1024, 128)


def _bits(t):
    return np.asarray(t).tobytes()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    np.savez(tmp / "inputs.npz", x=X, big=BIG)
    return W.run_ranks(W.reshard_ranks, 4, str(tmp))


def _jax_shards(arr, shape, names, spec):
    """JAX's reshard of arr onto a mesh of the first four devices: each
    device's shard, by the device's index in the mesh (= the port's rank)."""
    devs = jax.devices()[:4]
    mesh = Mesh(np.asarray(devs).reshape(shape), names)
    out = jax_reshard(arr, NamedSharding(mesh, spec))
    by_dev = {s.device: np.asarray(s.data) for s in out.addressable_shards}
    return [by_dev[d] for d in devs]


def test_reshard_bitwise_from_host_on_one_mesh_and_across(ranks):
    placements = {"host": (Shard(0),), "same_mesh": (Shard(1),),
                  "cross_mesh": (Shard(0), Shard(1)),
                  "tensor": (Shard(1), Shard(1))}
    for o in ranks:
        for name, want in placements.items():
            local, got, full = o[name]
            assert got == want, name
            assert _bits(full) == _bits(X), name
        assert o["scalar"] == ((), 5.0)
        assert _bits(o["tree"]["a"]) == _bits(X)
        assert _bits(o["tree"]["b"]) == _bits(X.T)


def test_shards_equal_jax_reshard_on_the_same_windows(ranks):
    cases = {"host": ((4,), ("p",), JP("p")),
             "same_mesh": ((4,), ("p",), JP(None, "p")),
             "cross_mesh": ((2, 2), ("a", "b"), JP("a", "b")),
             "tensor": ((2, 2), ("a", "b"), JP(None, ("a", "b")))}
    for name, (shape, names, spec) in cases.items():
        want = _jax_shards(X, shape, names, spec)
        for r, o in enumerate(ranks):
            assert _bits(o[name][0]) == _bits(want[r]), (name, r)
    rows = _jax_shards(X, (4,), ("p",), JP("p"))
    cols = _jax_shards(X.T.copy(), (4,), ("p",), JP(None, "p"))
    for r, o in enumerate(ranks):
        assert _bits(o["tree_per_leaf"][0]) == _bits(rows[r])
        assert _bits(o["tree_per_leaf"][1]) == _bits(cols[r])


def test_reshard_streaming_bounded_and_bitwise(ranks):
    chunk_bytes = 64 * 1024
    want = _jax_shards(BIG, (4,), ("p",), JP("p"))
    for r, o in enumerate(ranks):
        got, stats, ref = o["stream"]
        assert stats["chunks"] > stats["windows"], "leaf must be chunk-split"
        assert stats["peak_host_bytes"] <= 2 * chunk_bytes, stats
        assert _bits(got) == _bits(ref) == _bits(want[r])
        rep, rstats = o["stream_rep"]
        assert rstats["windows"] == 1
        assert _bits(rep) == _bits(BIG)


def test_reshard_streaming_from_a_windowed_reader(ranks):
    # JAX runs without x64: its shards in f32, widened here
    want = [w.astype(np.float64) for w in
            _jax_shards(BIG, (2, 2), ("a", "b"), JP("b", "a"))]
    for r, o in enumerate(ranks):
        got, stats, ref = o["reader"]
        assert got.dtype == torch.float64
        assert stats["peak_host_bytes"] <= 3 * 4096, stats
        assert _bits(got) == _bits(ref) == _bits(want[r])
