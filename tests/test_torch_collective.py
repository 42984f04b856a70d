"""The port's collective layer against the JAX package's.

- `Backend`/`ReduceOp` spellings, `Topology`, `ring_perm`,
  `infer_topology`, the quantizer's sizes and formulas: equal;
- `quantize` from the same f32 bits: q and scales BIT-equal, int8 and fp8,
  to the JAX package's `quantize` under `jit`, as its programs run it (XLA
  turns ``amax / qmax`` into ``amax * f32(1/qmax)``; op by op JAX divides,
  which can differ in the scale's last bit);
- stochastic rounding: unbiased (the statistic of the JAX package's
  `test_quantize_stochastic_rounding`) and deterministic for a generator
  seed; its draws are torch's, so they cannot equal `jax.random`'s;
- `LocalCollectiveGroup` against `XlaCollectiveGroup` on 4 devices;
- four gloo ranks (spawned, over FileStores) against the JAX package's
  programs under `shard_map` on 4 of the 8 virtual CPU devices, from numpy
  inputs: at `Topology(2, 2)` every sum has two terms, so `hier_grad_sync`
  is BIT-equal with quantization off and with int8/fp8 error feedback
  (residuals included); PRODUCT/MAX/MIN within rtol 1e-6; the module API
  on two ranks, a rebuild into a new generation, `allreduce_device` and its
  byte counts equal to the JAX package's formulas for the same calls.
"""

import collections
import importlib
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import _torch_dist_workers as W
from ray_tpu.util.collective import QuantizedAllreduce as JQ
from ray_tpu.util.collective import XlaCollectiveGroup
from ray_tpu.util.collective import hierarchy as JH
from ray_tpu.util.collective.types import ReduceOp as JOp
from ray_tpu.utils.jax_compat import shard_map
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective import hierarchy as H
from ray_tpu_torch.util.collective import reshard as R
from ray_tpu_torch.util.collective.dist_group import DistCollectiveGroup
from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

# the package exports a function of the module's name
JR = importlib.import_module("ray_tpu.util.collective.reshard")

# the reductions whose order may differ from the JAX package's (a product
# over 4 factors), as the JAX package's own PRODUCT test holds them
RTOL_REDUCE = 1e-6
N, SHARD, CHUNK = 128, 64, 16     # flat size, its intra shard, scale block


def _bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# ------------------------------------------------------------ names, sizes
def test_backend_and_reduce_op_spellings():
    for name in ("nccl", "xla", "ici", "tpu", "xla-multihost", "XLA"):
        assert col.Backend(name) == col.Backend.NCCL == "nccl"
    for name in ("gloo", "torch_gloo", "cpu"):
        assert col.Backend(name) == col.Backend.GLOO == "gloo"
    # the JAX package's head-KV group, not an alias of torch's gloo
    assert col.Backend("kv") == col.Backend.KV == "kv"
    with pytest.raises(ValueError, match="MPI"):
        col.Backend("mpi")
    with pytest.raises(ValueError, match="unknown"):
        col.Backend("carrier-pigeon")
    assert [op.name for op in col.ReduceOp] == [op.name for op in JOp]
    assert [op.value for op in col.ReduceOp] == [op.value for op in JOp]


def test_nccl_group_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = torch.distributed.FileStore(str(tmp_path / "s"), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistCollectiveGroup(store, "g", 1, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="CUDA"):
        col.init_collective_group(1, 0, "xla", "g", store=store)
    assert not col.is_group_initialized("g")


def test_module_api_refusals():
    # outside the runtime: actor groups need it, and a member without
    # store= has no head KV to meet through
    with pytest.raises(RuntimeError, match="ray_tpu_torch.init"):
        col.create_collective_group([], 0, [])
    with pytest.raises(ValueError, match="store"):
        col.init_collective_group(1, 0, "gloo", "nostore")
    with pytest.raises(RuntimeError, match="not initialized"):
        col.get_group("never")


def test_topology_ring_and_infer_match_jax(monkeypatch):
    for inter, intra in ((1, 1), (2, 2), (2, 3), (3, 2), (4, 1)):
        got, want = H.Topology(inter, intra), JH.Topology(inter, intra)
        assert got.world == want.world
        for i in range(inter):
            for j in range(intra):
                assert got.shard_index(i, j) == want.shard_index(i, j)
        assert H.ring_perm(inter * intra) == JH.ring_perm(inter * intra)
    with pytest.raises(ValueError):
        H.Topology(0, 2)
    cases = [
        ([{"rank": r, "host": f"h{r // 2}", "local_devices": 2}
          for r in range(4)], 4),
        ([{"rank": 0, "host": "a"}, {"rank": 1, "host": "a"},
          {"rank": 2, "host": "b"}], 3),
        ([{"rank": r, "host": f"h{r}"} for r in range(4)], 4),
        ([{"rank": r} for r in range(2)], 2),
        ([{"rank": r, "host": f"h{r % 3}"} for r in range(6)], 6),
    ]
    for members, world in cases:
        got, want = H.infer_topology(members, world), \
            JH.infer_topology(members, world)
        assert (got.inter, got.intra) == (want.inter, want.intra), members
    ov = H.Topology(1, 4)
    assert H.infer_topology(cases[0][0], 4, override=ov) is ov
    rows = H.rank_rows_by_host([{"rank": r, "host": f"h{(r + 1) % 2}"}
                                for r in (3, 0, 2, 1)])
    assert rows == [[0, 2], [1, 3]]
    monkeypatch.setenv("RAY_TPU_NODE_IP", "10.0.0.7")
    assert H.host_id() == "10.0.0.7"


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantizer_sizes_and_validation_match_jax(dtype):
    for chunk in (1, 16, 64, 4096):
        got = QuantizedAllreduce(dtype=dtype, chunk=chunk)
        want = JQ(dtype=dtype, chunk=chunk)
        assert got.qmax == want.qmax and got.key() == want.key()
        assert got.wire_dtype.itemsize == want.wire_dtype.itemsize
        assert str(got.wire_dtype).removeprefix("torch.") == \
            str(want.wire_dtype)
        for n in (1, 15, 16, 100, 128, 4097, 124_439_808):
            assert got.padded_size(n) == want.padded_size(n)
            assert got.wire_bytes(n) == want.wire_bytes(n)
    for kw in (dict(dtype="int4"), dict(chunk=0),
               dict(dtype="float8_e4m3fn", stochastic_rounding=True)):
        with pytest.raises(ValueError):
            JQ(**kw)
        with pytest.raises(ValueError):
            QuantizedAllreduce(**kw)


def _quant_input(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[::97] *= 300.0                 # outliers in some chunks
    x[:64] = 0.0                     # an all-zero chunk (scale 1)
    x[64:128] = np.float32(1e-30)    # a tiny one
    x[200] = 0.5 * np.float32(127)   # ties for round-half-even
    return x


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantize_bit_equal_to_jax(dtype, chunk):
    x = _quant_input(3)
    q_got, s_got = QuantizedAllreduce(dtype=dtype, chunk=chunk).quantize(
        torch.from_numpy(x))
    q_want, s_want = jax.jit(JQ(dtype=dtype, chunk=chunk).quantize)(
        jax.numpy.asarray(x))
    assert str(q_got.dtype).removeprefix("torch.") == str(q_want.dtype)
    assert q_got.shape == q_want.shape and s_got.shape == s_want.shape
    assert q_got.view(torch.uint8).numpy().tobytes() == \
        np.asarray(q_want).view(np.uint8).tobytes()
    assert _bits(s_got) == _bits(s_want)
    d_got = QuantizedAllreduce(dtype=dtype, chunk=chunk).dequantize(
        q_got, s_got)
    d_want = jax.jit(JQ(dtype=dtype, chunk=chunk).dequantize)(q_want, s_want)
    assert _bits(d_got) == _bits(d_want)


def test_stochastic_rounding_unbiased_and_deterministic():
    q = QuantizedAllreduce(dtype="int8", chunk=64, stochastic_rounding=True)
    x = torch.linspace(-1.0, 1.0, 64)
    q1, _ = q.quantize(x, torch.Generator().manual_seed(0))
    q2, _ = q.quantize(x, torch.Generator().manual_seed(0))
    assert torch.equal(q1, q2)
    q3, _ = q.quantize(x)   # no generator: round to nearest
    q4, _ = QuantizedAllreduce(dtype="int8", chunk=64).quantize(x)
    assert torch.equal(q3, q4)
    # 0.003 is ~0.38 of one quantum at scale 1/127: nearest rounding kills
    # it every time, stochastic rounding keeps its expectation
    sub = torch.tensor(np.r_[np.full(63, 0.003), 1.0].astype(np.float32))
    qn, _ = QuantizedAllreduce(dtype="int8", chunk=64).quantize(sub)
    assert int(qn.view(-1)[:63].abs().max()) == 0
    acc = np.zeros(63, np.float64)
    n = 200
    for i in range(n):
        qi, si = q.quantize(sub, torch.Generator().manual_seed(i))
        acc += q.dequantize(qi, si)[:63].double().numpy()
    assert abs(acc.mean() / n - 0.003) < 0.001


# ------------------------------------------------------------- local group
@pytest.fixture(scope="module")
def local_pair(devices8):
    port = col.LocalCollectiveGroup(["cpu"] * 4)
    ref = XlaCollectiveGroup(devices8[:4], group_name="port-parity")
    yield port, ref
    ref.destroy()


def test_local_group_matches_xla_group(local_pair):
    port, ref = local_pair
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(4)]
    ts = [torch.from_numpy(x) for x in xs]
    for op, jop in zip(col.ReduceOp, JOp):
        for a, b in zip(port.allreduce(ts, op), ref.allreduce(xs, jop)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL_REDUCE, atol=0)
    red = port.reduce(ts, 2, col.ReduceOp.MAX)
    want = ref.reduce(xs, 2, JOp.MAX)
    for a, b in zip(red, want):
        assert _bits(a) == _bits(b)
    for a, b in zip(port.broadcast(ts, 3), ref.broadcast(xs, 3)):
        assert _bits(a) == _bits(b)
    for row_a, row_b in zip(port.allgather(ts), ref.allgather(xs)):
        for a, b in zip(row_a, row_b):
            assert _bits(a) == _bits(b)
    rows = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(4)]
    for a, b in zip(port.reducescatter([torch.from_numpy(r) for r in rows]),
                    ref.reducescatter(rows)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    pairs = [(0, 1), (1, 2), (2, 0)]
    for a, b in zip(port.send_recv(ts, pairs), ref.send_recv(xs, pairs)):
        assert _bits(a) == _bits(b)
    port.barrier()
    with pytest.raises(ValueError, match="one per device"):
        port.allreduce(ts[:3])


def test_local_group_needs_devices_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        col.LocalCollectiveGroup()


def test_windowed_reader_matches_jax():
    rng = np.random.default_rng(2)
    full = rng.standard_normal((10, 6)).astype(np.float32)
    chunks = [(((0, 4), (0, 6)), "a"), (((4, 10), (0, 6)), "b")]
    blobs = {"a": full[:4], "b": full[4:]}

    def loader(key, r0, r1):
        return blobs[key][r0:r1]

    got = R.WindowedReader(full.shape, full.dtype, chunks, loader)
    want = JR.WindowedReader(full.shape, full.dtype, chunks, loader)
    for win in (((0, 10), (0, 6)), ((3, 7), (1, 5)), ((9, 10), (5, 6))):
        assert _bits(got.read(win)) == _bits(want.read(win))
        assert _bits(R._HostReader(full).read(win)) == \
            _bits(JR._HostReader(full).read(win))
    scalar = R.WindowedReader((), np.float32, [((), "s")],
                              lambda k, a, b: np.float32(4.5))
    assert float(scalar.read(())) == 4.5


# ------------------------------------------------------- four gloo ranks
@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collective4")
    rng = np.random.default_rng(11)
    inputs = {
        "v": (rng.standard_normal((4, N)) *
              np.exp(rng.standard_normal((4, N)))).astype(np.float32),
        "r": (rng.standard_normal((4, SHARD)) * 0.01).astype(np.float32),
        "p": (1.0 + 0.2 * rng.standard_normal((4, 32))).astype(np.float32),
    }
    np.savez(tmp / "inputs.npz", **inputs)
    return inputs, W.run_ranks(W.collective_ranks, 4, str(tmp))


def _jax_program(body, n_args, x, *more, flat=True):
    """body under shard_map over Topology(2, 2)'s mesh of 4 virtual CPU
    devices; row d of each [4, n] input goes to member d. A `flat` body
    takes and returns [n] (hier_grad_sync_program), the others [1, n]."""
    topo = JH.Topology(2, 2)
    mesh = topo.mesh(jax.devices()[:4])
    spec = PS(("inter", "intra"))

    def fn(*blocks):
        if not flat:
            return body(*blocks)
        out = body(*(b[0] for b in blocks))
        return tuple(o[None] for o in out) if isinstance(out, tuple) \
            else out[None]

    outs = spec if n_args == 1 else (spec,) * n_args
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * (1 + len(more)),
                          out_specs=outs))
    args = [jax.device_put(a, NamedSharding(mesh, spec)) for a in (x,) + more]
    res = f(*args)
    return [np.asarray(r) for r in res] if n_args > 1 else np.asarray(res)


def test_members_take_the_mesh_positions(ranks4):
    _, outs = ranks4
    assert [o["pos"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["ddp_topology"] == (2, 2) for o in outs)   # two hosts
    assert all(o["inferred"] == (1, 4) for o in outs)   # one host here


def test_hier_grad_sync_f32_bit_equal_to_jax(ranks4):
    inputs, outs = ranks4
    want = _jax_program(JH.hier_grad_sync_program(JH.Topology(2, 2)), 1,
                        inputs["v"])
    for d, o in enumerate(outs):
        assert _bits(o["sync_f32"]) == _bits(want[d]), d
        assert _bits(o["phases"]) == _bits(want[d]), d
    v = inputs["v"]
    assert _bits(want[0]) == _bits((v[0] + v[1]) + (v[2] + v[3]))


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_hier_grad_sync_quantized_bit_equal_to_jax(ranks4, dtype):
    inputs, outs = ranks4
    q = JQ(dtype=dtype, chunk=CHUNK)
    topo = JH.Topology(2, 2)
    want_out, want_r = _jax_program(
        JH.hier_grad_sync_program(topo, q, error_feedback=True), 2,
        inputs["v"], inputs["r"])
    plain = _jax_program(JH.hier_grad_sync_program(topo, q), 1, inputs["v"])
    ef_body = _jax_program(JH.hier_allreduce_ef_program(topo, q), 2,
                           inputs["v"], inputs["r"], flat=False)
    for d, o in enumerate(outs):
        got_out, got_r = o[f"sync_{dtype}_ef"]
        assert _bits(got_out) == _bits(want_out[d]), d
        assert _bits(got_r) == _bits(want_r[d]), d
        assert _bits(o[f"sync_{dtype}"]) == _bits(plain[d]), d
        ef_out, ef_r = o[f"allreduce_ef_{dtype}"]
        assert _bits(ef_out) == _bits(ef_body[0][d])
        assert _bits(ef_r) == _bits(ef_body[1][d])
        # the ring moves the same bits as the all-gather
        ring_out, ring_r = o[f"ring_{dtype}_ef"]
        gat_out, gat_r = o[f"gather_{dtype}_ef"]
        assert torch.equal(ring_out, gat_out) and torch.equal(ring_r, gat_r)
    err = np.abs(want_out[0] - inputs["v"].sum(0)).max()
    assert err <= 0.07 * np.abs(inputs["v"]).sum(0).max()


@pytest.mark.parametrize("op", ["PRODUCT", "MAX", "MIN"])
def test_hier_allreduce_other_ops_match_jax(ranks4, op):
    inputs, outs = ranks4
    want = _jax_program(
        JH.hier_allreduce_program(JH.Topology(2, 2), JOp[op]), 1,
        inputs["p"], flat=False)
    ref = {"PRODUCT": np.prod, "MAX": np.max, "MIN": np.min}[op](
        inputs["p"], axis=0)
    for d, o in enumerate(outs):
        got = o[f"allreduce_{op}"].numpy()
        np.testing.assert_allclose(got, want[d], rtol=RTOL_REDUCE, atol=0)
        np.testing.assert_allclose(got, ref, rtol=RTOL_REDUCE, atol=0)
        assert _bits(got) == _bits(outs[0][f"allreduce_{op}"])
    sum_want = _jax_program(JH.hier_allreduce_program(JH.Topology(2, 2)), 1,
                            inputs["p"], flat=False)
    assert _bits(outs[3]["allreduce_SUM"]) == _bits(sum_want[3])
    chunked = [o["prod_chunked"] for o in outs]
    assert all(torch.equal(c, o["prod_whole"]) for c, o in zip(chunked, outs))


def test_hier_reduce_scatter_and_all_gather_match_jax(ranks4):
    inputs, outs = ranks4
    topo = JH.Topology(2, 2)
    rs = _jax_program(JH.hier_reduce_scatter_program(topo), 1, inputs["v"],
                      flat=False)
    for d, o in enumerate(outs):
        assert _bits(o["rs"]) == _bits(rs[d]), d
        i, j = o["pos"]
        per = N // 4
        slot = topo.shard_index(i, j)
        np.testing.assert_allclose(
            o["rs_max"].numpy(), inputs["v"].max(0)[slot * per:][:per])
        assert _bits(o["ag"]) == _bits(o["sync_f32"])


def test_module_api_on_two_ranks(ranks4):
    _, outs = ranks4
    api = [o["api"] for o in outs[:2]]
    x = [np.arange(6, dtype=np.float32) + 10 * r for r in range(2)]
    for r, a in enumerate(api):
        assert (a["rank"], a["size"], a["init"]) == (r, 2, True)
        for op, fn in (("SUM", np.sum), ("MAX", np.max), ("MIN", np.min),
                       ("PRODUCT", np.prod)):
            np.testing.assert_array_equal(a[f"allreduce_{op}"].numpy(),
                                          fn(np.stack(x) + 1, axis=0))
        np.testing.assert_array_equal(a["reduce"].numpy(),
                                      x[0] + x[1] if r == 1 else x[r])
        np.testing.assert_array_equal(a["broadcast"].numpy(), x[1])
        assert [t.tolist() for t in a["allgather_int8"]] == \
            [xi.astype(np.int8).tolist() for xi in x]
        assert [t.float().tolist() for t in a["allgather_fp8"]] == \
            [torch.from_numpy(xi / 4).to(torch.float8_e4m3fn).float().tolist()
             for xi in x]
        rows = np.arange(8, dtype=np.float32).reshape(2, 4)
        np.testing.assert_array_equal(a["reducescatter"].numpy(),
                                      (rows * 1 + rows * 2)[r])
        np.testing.assert_array_equal(a["reducescatter_max"].numpy(),
                                      (rows * 2)[r])
    assert api[0]["sendrecv"].tolist() == [2.0, 4.0, 6.0]
    assert api[1]["sendrecv"].tolist() == [1.0, 2.0, 3.0]
    assert api[1]["recv_device"].tolist() == [[7.0, 7.0], [7.0, 7.0]]
    assert api[0]["member1_gen0"]["world"] == 2


def test_rebuild_into_a_new_generation(ranks4):
    _, outs = ranks4
    for o in outs:
        rb = o["rebuilt"]
        assert (rb["gen"], rb["size"]) == (1, 4)
        assert rb["sum"].tolist() == [6.0, 6.0]
        assert rb["member1"]["world"] == 4 and rb["member1"]["rank"] == 1


def _jax_counts(calls) -> tuple:
    """collective_bytes_total and the quantization saving as the JAX
    package counts `calls`: ("op", array) through `_op_span`, ("hier", op,
    colpad, quantize) through `XlaMultihostGroup._account_hier`."""
    from ray_tpu.util.collective import collective as jcol
    from ray_tpu.util.collective.xla_multihost import XlaMultihostGroup

    counts, saved = collections.Counter(), collections.Counter()

    def spy(op, nbytes, dtype, hop="world"):
        counts[(op, str(dtype), hop)] += int(nbytes)

    old = JH.account_collective, JH.account_quant_saving
    JH.account_collective = spy
    JH.account_quant_saving = lambda b: saved.update(
        {"bytes": int(b)} if b > 0 else {})
    try:
        fake = types.SimpleNamespace(topology=JH.Topology(2, 2))
        for call in calls:
            if call[0] == "op":
                with jcol._op_span(call[1], "g", call[2]):
                    pass
            else:
                XlaMultihostGroup._account_hier(fake, *call[1:])
    finally:
        JH.account_collective, JH.account_quant_saving = old
    return dict(counts), dict(saved)


def test_byte_counts_equal_jax_formulas(ranks4):
    import ml_dtypes

    _, outs = ranks4
    x = np.zeros(6, np.float32)
    rows = np.zeros((2, 4), np.float32)
    calls = [("op", "allreduce", x)] * 4 + [
        ("op", "reduce", x), ("op", "broadcast", x),
        ("op", "allgather", x.astype(np.int8)),
        ("op", "allgather", x.astype(ml_dtypes.float8_e4m3fn)),
        ("op", "reducescatter", rows), ("op", "reducescatter", rows)]
    want, _ = _jax_counts(calls)
    for o in outs[:2]:
        assert o["api"]["bytes"] == want
    q = JQ(dtype="int8", chunk=CHUNK)
    want_dev = _jax_counts([
        ("hier", JOp.SUM, SHARD, None), ("hier", JOp.SUM, SHARD, None),
        ("hier", JOp.MAX, SHARD, None), ("hier", JOp.SUM, SHARD, q),
        ("hier", JOp.SUM, SHARD, q), ("hier", JOp.SUM, 50, None)])
    for o in outs:
        assert o["dev_bytes"] == want_dev


def test_allreduce_device_and_tree(ranks4):
    inputs, outs = ranks4
    v = inputs["v"]
    for o in outs:
        assert _bits(o["dev_f32"]) == _bits(outs[0]["sync_f32"])
        assert _bits(o["dev_avg"]) == _bits(outs[0]["sync_f32"] / 4)
        np.testing.assert_array_equal(o["dev_max"].numpy(), v.max(0))
        first, second = o["dev_int8_ef"]
        # from a zero residual the quantized exchange gives the fused
        # sync's bits; the second call carries the first one's residual
        assert _bits(first) == _bits(outs[0]["sync_int8"])
        assert not torch.equal(first, second)
        vb = torch.from_numpy(v[:, :99]).bfloat16().float()
        assert torch.equal(o["dev_odd"],
                           ((vb[0] + vb[1]) + (vb[2] + vb[3])).bfloat16())
        tree = o["tree_avg"]
        np.testing.assert_allclose(tree["b"].numpy(), v[:, :5].mean(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(tree["a"]["w"].numpy(),
                                   v[:, 5:11].mean(0).reshape(2, 3),
                                   rtol=1e-6)
        assert o["tree_world1"]["a"]["w"].shape == (2, 3)
