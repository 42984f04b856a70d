"""The port's `kv` collective group against the JAX package's.

Two actors of each runtime form a `kv` group (collectives carried by the
head's KV and the shm store) through `create_collective_group` and run
every op on the same seeded inputs: allreduce (SUM, PRODUCT, MIN, MAX,
and a bf16 SUM), reduce, allgather, reducescatter, send/recv, barrier and
broadcast. The results are bit-equal. Then the order that hangs the JAX
group (allreduce, broadcast(src 1), allgather: its garbage collection
deletes a key a peer has yet to read) runs 50 times on the port alone,
each op with its own timeout; the port collects a key only once every
peer's progress is past it.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

WORLD = 2
ROUNDS = 50


def _inputs():
    rng = np.random.default_rng(11)
    return [{"x": rng.standard_normal((3, 5)).astype(np.float32),
             "p": (1 + 0.1 * rng.standard_normal((3, 5))).astype(np.float32),
             "i": rng.integers(-50, 50, (4,)).astype(np.int32),
             "rs": rng.standard_normal((WORLD, 6)).astype(np.float32),
             "bf": rng.standard_normal((7,)).astype(np.float32)}
            for _ in range(WORLD)]


def _jax_results(xs):
    @ray_tpu.remote
    class Member:
        def run(self, group, d, rank):
            import ml_dtypes

            from ray_tpu.util.collective import collective as col
            from ray_tpu.util.collective.types import ReduceOp

            g = dict(group_name=group)
            out = {}
            for op in ("SUM", "PRODUCT", "MIN", "MAX"):
                src = d["p"] if op == "PRODUCT" else d["x"]
                out[f"allreduce_{op}"] = col.allreduce(
                    src.copy(), op=getattr(ReduceOp, op), **g)
            out["allreduce_int"] = col.allreduce(d["i"].copy(), **g)
            out["allreduce_bf16"] = col.allreduce(
                d["bf"].astype(ml_dtypes.bfloat16), **g).view(np.uint16)
            out["reduce"] = col.reduce(d["x"].copy(), dst_rank=0, **g)
            out["allgather"] = np.stack(col.allgather(None, d["x"], **g))
            out["reducescatter"] = col.reducescatter(d["rs"], **g)
            col.barrier(**g)
            if rank == 0:
                col.send(d["x"] * 2, dst_rank=1, **g)
            else:
                out["recv"] = col.recv(np.zeros((3, 5), np.float32),
                                       src_rank=0, **g)
            # broadcast last: the JAX group's garbage collection races an
            # op that follows a broadcast
            out["broadcast"] = col.broadcast(d["x"].copy(), src_rank=1, **g)
            return {k: np.asarray(v) for k, v in out.items()}

    try:
        ray_tpu.init(num_cpus=2, num_tpu_chips=0, max_workers=4)
        from ray_tpu.util.collective import collective as col

        actors = [Member.remote() for _ in range(WORLD)]
        col.create_collective_group(actors, WORLD, list(range(WORLD)),
                                    backend="kv", group_name="kvp")
        return ray_tpu.get([a.run.remote("kvp", d, r) for r, (a, d) in
                            enumerate(zip(actors, xs))], timeout=120)
    finally:
        ray_tpu.shutdown()


@ray_tpu_torch.remote
class PortMember:
    def run(self, group, d, rank):
        import torch

        from ray_tpu_torch.util.collective import collective as col
        from ray_tpu_torch.util.collective.types import ReduceOp

        g = dict(group_name=group)
        t = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
        out = {}
        for op in ("SUM", "PRODUCT", "MIN", "MAX"):
            src = t["p"] if op == "PRODUCT" else t["x"]
            out[f"allreduce_{op}"] = col.allreduce(
                src.clone(), op=getattr(ReduceOp, op), **g)
        out["allreduce_int"] = col.allreduce(t["i"].clone(), **g)
        out["allreduce_bf16"] = col.allreduce(
            t["bf"].to(torch.bfloat16), **g).view(torch.int16).numpy().view(
            np.uint16)
        # numpy in, numpy out (written in place), as in the JAX package
        out["reduce"] = col.reduce(d["x"].copy(), dst_rank=0, **g)
        out["allgather"] = torch.stack(col.allgather(None, t["x"], **g))
        out["reducescatter"] = col.reducescatter(t["rs"], **g)
        col.barrier(**g)
        if rank == 0:
            col.send(t["x"] * 2, dst_rank=1, **g)
        else:
            out["recv"] = col.recv(torch.zeros((3, 5)), src_rank=0, **g)
        out["broadcast"] = col.broadcast(t["x"].clone(), src_rank=1, **g)
        out["backend"] = np.asarray(col.get_group(group).backend_name)
        return {k: np.asarray(v) for k, v in out.items()}

    def rounds(self, group, rank, n):
        """allreduce, broadcast(src 1), allgather n times, each op with its
        own timeout (a lost key raises TimeoutError instead of hanging)."""
        import torch

        from ray_tpu_torch.util.collective import collective as col

        grp = col.get_group(group)
        last = None
        for i in range(n):
            x = torch.full((4,), float(rank + i))
            a = grp.allreduce(x.clone(), timeout=30)
            b = grp.broadcast(x.clone(), src_rank=1, timeout=30)
            c = grp.allgather(x, timeout=30)
            last = (a.tolist(), b.tolist(), [p.tolist() for p in c])
            assert last == ([2.0 * i + 1] * 4, [i + 1.0] * 4,
                            [[float(i)] * 4, [i + 1.0] * 4]), (i, last)
        col.destroy_collective_group(group)
        return n, last


@pytest.fixture(scope="module")
def port_runtime():
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
        yield
    finally:
        ray_tpu_torch.shutdown()


def test_kv_group_bit_equal_to_jax_on_every_op(port_runtime):
    xs = _inputs()
    ray_tpu_torch.shutdown()      # one runtime at a time on this host
    want = _jax_results(xs)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    from ray_tpu_torch.util.collective import collective as col

    actors = [PortMember.remote() for _ in range(WORLD)]
    col.create_collective_group(actors, WORLD, list(range(WORLD)),
                                backend="kv", group_name="kvp")
    got = ray_tpu_torch.get([a.run.remote("kvp", d, r) for r, (a, d) in
                             enumerate(zip(actors, xs))], timeout=120)
    for r in range(WORLD):
        assert str(got[r].pop("backend")) == "kv"
        assert got[r].keys() == want[r].keys()
        for k in want[r]:
            assert got[r][k].dtype == want[r][k].dtype, k
            assert got[r][k].tobytes() == want[r][k].tobytes(), (r, k)
    # the op results the ranks agree on, and the reduce lands on rank 0
    assert got[0]["allreduce_bf16"].tobytes() == \
        got[1]["allreduce_bf16"].tobytes()
    np.testing.assert_array_equal(got[1]["reduce"], xs[1]["x"])
    np.testing.assert_array_equal(got[1]["recv"], xs[0]["x"] * 2)
    for a in actors:
        ray_tpu_torch.kill(a)


def test_allreduce_broadcast_allgather_fifty_rounds(port_runtime):
    from ray_tpu_torch.util.collective import collective as col

    actors = [PortMember.remote() for _ in range(WORLD)]
    col.create_collective_group(actors, WORLD, list(range(WORLD)),
                                backend="kv", group_name="rounds")
    out = ray_tpu_torch.get([a.rounds.remote("rounds", r, ROUNDS)
                             for r, a in enumerate(actors)], timeout=300)
    assert [n for n, _ in out] == [ROUNDS] * WORLD
    for a in actors:
        ray_tpu_torch.kill(a)


def test_kv_group_made_again_under_its_name(port_runtime):
    """An imperative kv group destroyed by every member and made again
    under the same name is a new incarnation: its ops never read the old
    one's keys or progress."""
    @ray_tpu_torch.remote
    class Again:
        def run(self, rank):
            import torch

            from ray_tpu_torch.util.collective import collective as col

            outs = []
            for k in range(3):
                col.init_collective_group(WORLD, rank, "kv", "again")
                x = torch.full((2,), float(10 * k + rank))
                outs.append(col.allreduce(x.clone(),
                                          group_name="again").tolist())
                outs.append(col.broadcast(x.clone(), src_rank=1,
                                          group_name="again").tolist())
                col.destroy_collective_group("again")
            return outs

    actors = [Again.remote() for _ in range(WORLD)]
    got = ray_tpu_torch.get([a.run.remote(r) for r, a in enumerate(actors)],
                            timeout=120)
    want = []
    for k in range(3):
        want += [[20.0 * k + 1] * 2, [10.0 * k + 1] * 2]
    assert got == [want, want]
    for a in actors:
        ray_tpu_torch.kill(a)
