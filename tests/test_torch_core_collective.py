"""Actor collective groups met through the head's KV, on gloo.

Two actors of the port's runtime, grouped by `create_collective_group`,
attach on their first op and run `allreduce`, `broadcast` and `allgather`;
their results equal those of the JAX package's `kv` group over two of its
actors on the same inputs. A group made by `init_collective_group` inside
the actors, without `store=`, meets through the runtime the same way.
A group destroyed by its members can be declared or made again by its
name: rank 0, which serves the group's store, keeps it up until the other
members have left. Rank 0 looks the others' membership records up without
waiting: a record withdrawn between a `check` and a `get` used to make the
`get` block for the store's whole timeout (rank 0's `destroy` then raised
DistStoreError after 60 s when the other member left late, as under the
whole suite's load); the lookup is now one `compare_set` that never
blocks.
The NCCL version over two `num_gpus=1` actors is in tests/test_torch_cuda.py.
"""

import os
import tempfile

import numpy as np

import ray_tpu
import ray_tpu_torch


def _inputs(world=2):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((3, 5)).astype(np.float32)
            for _ in range(world)]


def _jax_results(xs, redeclare=False):
    """The JAX `kv` group's results by rank (rank r holds xs[r]); with
    `redeclare`, also those of the group declared again, ranks reversed,
    after every member destroyed it (by the second declaration's ranks)."""
    @ray_tpu.remote
    class Member:
        def run(self, group, x):
            from ray_tpu.util.collective import collective as col

            # broadcast last: the kv group deletes a rank's key of two ops
            # back as it starts an op, and a broadcast's source does not
            # wait, so an op after a broadcast could delete a key the
            # other rank has yet to read (it would then wait forever)
            return {"allreduce": col.allreduce(x.copy(), group_name=group),
                    "allgather": col.allgather(None, x, group_name=group),
                    "broadcast": col.broadcast(x.copy(), src_rank=1,
                                               group_name=group)}

        def leave(self, group):
            from ray_tpu.util.collective import collective as col

            col.destroy_collective_group(group)
            return col.is_group_initialized(group)

    try:
        ray_tpu.init(num_cpus=2, num_tpu_chips=0, max_workers=4)
        actors = [Member.remote() for _ in xs]
        from ray_tpu.util.collective import collective as col

        col.create_collective_group(actors, len(xs), list(range(len(xs))),
                                    backend="kv", group_name="parity")
        first = ray_tpu.get([a.run.remote("parity", x)
                             for a, x in zip(actors, xs)], timeout=120)
        if not redeclare:
            return first
        assert ray_tpu.get([a.leave.remote("parity") for a in actors],
                           timeout=60) == [False, False]
        col.create_collective_group(actors, 2, [1, 0], backend="kv",
                                    group_name="parity")
        second = ray_tpu.get([a.run.remote("parity", x)
                              for a, x in zip(actors, xs[::-1])],
                             timeout=120)
        return first, second[::-1]
    finally:
        ray_tpu.shutdown()


def _member_class():
    class Member:
        def run(self, group, x):
            import torch

            from ray_tpu_torch.util.collective import collective as col

            t = torch.from_numpy(x)
            return {"allreduce": col.allreduce(t.clone(), group_name=group),
                    "allgather": col.allgather(None, t, group_name=group),
                    "broadcast": col.broadcast(t.clone(), src_rank=1,
                                               group_name=group),
                    "rank": col.get_rank(group)}

        def join(self, world, rank, group):
            from ray_tpu_torch.util.collective import collective as col

            col.init_collective_group(world, rank, "gloo", group)
            return col.get_collective_group_size(group)

        def leave(self, group):
            from ray_tpu_torch.util.collective import collective as col

            col.destroy_collective_group(group)
            return col.is_group_initialized(group)

    return ray_tpu_torch.remote(Member)


def _as_numpy(res):
    return {k: ([np.asarray(t) for t in v] if isinstance(v, list)
                else np.asarray(v)) for k, v in res.items() if k != "rank"}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = _as_numpy(g)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.stack(g[k]) if k == "allgather"
                                          else g[k],
                                          np.stack(w[k]) if k == "allgather"
                                          else w[k], err_msg=k)


def test_actor_group_matches_jax_kv_group():
    xs = _inputs()
    want = _jax_results(xs)   # by rank: rank r holds xs[r]
    Member = _member_class()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
        from ray_tpu_torch.util.collective import collective as col

        actors = [Member.remote() for _ in xs]
        # ranks declared in reverse: the first actor is rank 1
        col.create_collective_group(actors, 2, [1, 0], backend="gloo",
                                    group_name="parity")
        got = ray_tpu_torch.get([a.run.remote("parity", x) for a, x in
                                 zip(actors, xs[::-1])], timeout=120)
        assert [g["rank"] for g in got] == [1, 0]
        _assert_same(got[::-1], want)
        try:
            col.create_collective_group(actors, 2, [0, 1],
                                        group_name="parity")
            raise AssertionError("a second declaration was accepted")
        except RuntimeError as e:
            assert "already exists" in str(e)
    finally:
        ray_tpu_torch.shutdown()


def test_declared_group_destroyed_and_declared_again():
    # every member destroys the declared group (which deletes the
    # declaration from the head's KV, as the JAX package's destroy does),
    # then the same name is declared again with the ranks reversed: the
    # members attach to the new group, and both groups' results equal the
    # JAX kv group's through the same sequence
    xs = _inputs()
    want_first, want_second = _jax_results(xs, redeclare=True)
    Member = _member_class()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
        from ray_tpu_torch.util.collective import collective as col

        actors = [Member.remote() for _ in xs]
        col.create_collective_group(actors, 2, [0, 1], backend="gloo",
                                    group_name="parity")
        first = ray_tpu_torch.get([a.run.remote("parity", x) for a, x in
                                   zip(actors, xs)], timeout=120)
        _assert_same(first, want_first)
        assert ray_tpu_torch.get([a.leave.remote("parity") for a in actors],
                                 timeout=120) == [False, False]
        col.create_collective_group(actors, 2, [1, 0], backend="gloo",
                                    group_name="parity")
        second = ray_tpu_torch.get([a.run.remote("parity", x) for a, x in
                                    zip(actors, xs[::-1])], timeout=120)
        assert [g["rank"] for g in second] == [1, 0]
        _assert_same(second[::-1], want_second)
    finally:
        ray_tpu_torch.shutdown()


def test_imperative_group_meets_through_the_runtime():
    xs = _inputs()
    want = _jax_results(xs)
    Member = _member_class()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
        actors = [Member.remote() for _ in xs]
        for round_ in range(2):   # destroyed, then made again by the name
            assert ray_tpu_torch.get(
                [a.join.remote(2, r, "imp") for r, a in enumerate(actors)],
                timeout=120) == [2, 2]
            got = ray_tpu_torch.get([a.run.remote("imp", x)
                                     for a, x in zip(actors, xs)],
                                    timeout=120)
            _assert_same(got, want)
            assert ray_tpu_torch.get([a.leave.remote("imp") for a in actors],
                                     timeout=120) == [False, False]
    finally:
        ray_tpu_torch.shutdown()


def test_membership_lookup_never_waits_on_a_withdrawn_record():
    """`lookup_membership` without `wait` reads a record in one store op
    that never blocks and creates nothing: a record that is there comes
    back, one withdrawn (a member's `destroy`) reads as None at once, on
    every store a group meets through (TCP, file, hash)."""
    import datetime
    import json
    import time

    import torch.distributed as dist

    from ray_tpu_torch.util.collective.dist_group import lookup_membership

    class Recording:
        """A store proxy that records which ops a lookup makes."""

        def __init__(self, store):
            self.store, self.ops = store, []

        def __getattr__(self, name):
            self.ops.append(name)
            return getattr(self.store, name)

    tcp = dist.TCPStore("127.0.0.1", 0, 1, True,
                        datetime.timedelta(seconds=30))
    stores = [tcp, dist.HashStore(),
              dist.FileStore(os.path.join(tempfile.mkdtemp(), "fs"), 1)]
    record = {"group": "g", "rank": 1, "world": 2}
    for base in stores:
        store = dist.PrefixStore("collective/g/0/", base)
        assert lookup_membership(store, 1) is None
        assert not store.check(["members/1"])   # the lookup created nothing
        store.set("members/1", json.dumps(record))
        assert lookup_membership(store, 1) == record
        assert lookup_membership(store, 1, wait=True) == record
        store.delete_key("members/1")   # the member withdraws it
        t0 = time.monotonic()
        assert lookup_membership(store, 1) is None
        assert time.monotonic() - t0 < 5
        rec = Recording(store)
        assert lookup_membership(rec, 1) is None
        assert rec.ops == ["compare_set"], rec.ops
