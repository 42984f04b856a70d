"""Ring and Ulysses attention in the port (`ray_tpu_torch/ops/
ring_attention.py`) against the JAX package's (`ray_tpu/ops/
ring_attention.py`) on the same seeded inputs.

- `_chunk_update`, plain torch, against JAX's, causal and not, at chunk
  offsets that make a pair diagonal, fully visible and fully masked;
- the ring's per-rank schedule driven for sp virtual ranks in one process
  (what `chip_smoke.py` runs on one card) against one flash call over the
  whole sequence, its plain kernels called once per live chunk pair;
- ring and Ulysses on gloo ranks (spawned once per module for each world
  size): sp=2, sp=4 and dp=2,sp=2, against JAX's `ring_attention` and
  `ulysses_attention` on `build_mesh(MeshConfig(...))` of virtual CPU
  devices, forward within atol=2e-5, rtol=1e-4 and gradients within
  atol=5e-4, rtol=1e-3 (`tests/test_ops_attention.py`'s bounds); the plain
  kernels called rank + 1 times (causal) on sp rank `rank`; the bytes
  accounted, op names and all, equal to the JAX package's for the same
  shapes;
- the ring past the kernels' own shapes: head dims 48 and 80 (padded to
  the kernels' widths) and chunks of 96 and 250 positions (250 padded to
  256, the padded keys masked by K1's and K2's `kv_len`): causal Dh 48 in
  chunks of 250 on sp=4 and non-causal Dh 80 in chunks of 96 on sp=2
  within the same bounds of JAX's ring; the virtual ring at both head dims
  and chunk lengths, causal and not, against `mha_reference`;
- with no mesh both are `mha_reference` (the JAX rule); a head dim past
  128, or a sequence that sp does not divide, raises on every rank.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from ray_tpu.ops.flash_attention import mha_reference as j_mha
from ray_tpu.parallel.mesh import MeshConfig, build_mesh, use_mesh
from ray_tpu_torch.ops import flash_attention as PF
from ray_tpu_torch.ops import ring_attention as PR

# the module (ray_tpu.ops re-exports its function under the same name)
JR = importlib.import_module("ray_tpu.ops.ring_attention")
TOL = dict(atol=2e-5, rtol=1e-4)
TOL_GRAD = dict(atol=5e-4, rtol=1e-3)
B, H, T, D = 2, 4, 64, 32
SHAPE = (T, D)
# past the kernels' own shapes: chunks of 250 (padded to 256) causal at
# Dh 48 on sp=4, chunks of 96 non-causal at Dh 80 on sp=2 (the virtual
# ring takes the other combinations against the dense reference)
FOUR = [("ring", {"sp": 4}, True, SHAPE), ("ring", {"sp": 4}, False, SHAPE),
        ("ring", {"dp": 2, "sp": 2}, True, SHAPE),
        ("ulysses", {"sp": 4}, True, SHAPE),
        ("ulysses", {"dp": 2, "sp": 2}, True, SHAPE),
        ("ring", {"sp": 4}, True, (1000, 48))]
TWO = [("ring", {"sp": 2}, True, SHAPE), ("ulysses", {"sp": 2}, False, SHAPE),
       ("ring", {"sp": 2}, False, (192, 80))]


def _inputs(seed=5, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, H, *shape), dtype=np.float32)
            for n in ("q", "k", "v", "do")}


def _key(impl, config, causal, shape):
    return (impl, tuple(sorted(config.items())), causal, shape)


def _jax(impl, config, causal, inp):
    """JAX's ring or Ulysses on build_mesh(config): (out, (dq, dk, dv),
    {(op, dtype, hop): bytes} of one eager call)."""
    n = int(np.prod(list(config.values())))
    mesh = build_mesh(MeshConfig(**config), devices=jax.devices()[:n])
    fn = getattr(JR, f"{impl}_attention")
    q, k, v, do = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "do"))
    counts = {}

    def spy(op, nbytes, dtype, hop="world"):
        counts[(op, str(dtype), hop)] = counts.get(
            (op, str(dtype), hop), 0) + int(nbytes)

    old, JR.account_collective = JR.account_collective, spy
    try:
        with use_mesh(mesh):
            fn(q, k, v, causal=causal)       # eager: accounts its bytes
            out, vjp = jax.vjp(lambda *t: fn(*t, causal=causal), q, k, v)
    finally:
        JR.account_collective = old
    return np.asarray(out), [np.asarray(g) for g in vjp(do)], counts


def _spawn(tmp_path_factory, world, cases):
    """{shape: inputs} and the ranks' outputs."""
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    inp = {shape: _inputs(shape=shape) for shape in {c[3] for c in cases}}
    np.savez(tmp / "inputs.npz", **{f"{n}{t}x{d}": a
                                    for (t, d), arrs in inp.items()
                                    for n, a in arrs.items()})
    outs = W.run_ranks(W.ring_ranks, world, str(tmp), cases)
    return inp, outs


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory, 4, FOUR)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory, 2, TWO)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_off,k_off", [(16, 16), (32, 0), (0, 48)])
def test_chunk_update_matches_jax(causal, q_off, k_off):
    rng = np.random.default_rng(q_off + k_off)
    q, kc, vc = (rng.standard_normal((2, 3, 16, 32), dtype=np.float32)
                 for _ in range(3))
    m = rng.standard_normal((2, 3, 16, 1), dtype=np.float32)
    l = rng.uniform(0.5, 2.0, (2, 3, 16, 1)).astype(np.float32)
    acc = rng.standard_normal((2, 3, 16, 32), dtype=np.float32)
    scale = 1 / math.sqrt(32)
    want = JR._chunk_update(*(jnp.asarray(a) for a in (q, kc, vc, m, l,
                                                        acc)),
                            scale, q_off, k_off, causal)
    got = PR._chunk_update(*(torch.from_numpy(a) for a in (q, kc, vc, m, l,
                                                           acc)),
                           scale, q_off, k_off, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_virtual_ring_matches_one_flash_call(sp, causal):
    inp = {n: torch.from_numpy(a) for n, a in _inputs(sp).items()}
    q, k, v, do = (inp[n] for n in ("q", "k", "v", "do"))
    chunks = [t.chunk(sp, dim=2) for t in (q, k, v, do)]
    scale = 1 / math.sqrt(D)
    fwd = PR.drive_virtual([PR.ring_forward(
        chunks[0][r], chunks[1][r], chunks[2][r], r, sp, causal, scale)
        for r in range(sp)])
    bwd = PR.drive_virtual([PR.ring_backward(
        chunks[0][r], chunks[1][r], chunks[2][r], *fwd[r], chunks[3][r], r,
        sp, causal, scale) for r in range(sp)])
    out, lse = (torch.cat(t, dim=2) for t in zip(*fwd))
    want_out, want_lse = PF.flash_attention_fwd(q, k, v, causal, scale)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)
    got = [torch.cat(t, dim=2) for t in zip(*bwd)]
    want = PF.flash_attention_bwd(q, k, v, want_out, want_lse, do, causal,
                                  scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)


def test_ring_forward_launches_one_k1_a_live_pair(monkeypatch):
    calls = []
    orig = PF.flash_attention_reference

    def spy(q, k, v, causal, *a, **kw):
        calls.append(causal)
        return orig(q, k, v, causal, *a, **kw)

    monkeypatch.setattr(PF, "flash_attention_reference", spy)
    sp = 4
    q = torch.from_numpy(_inputs()["q"])
    PR.drive_virtual([PR.ring_forward(c, c, c, r, sp, True, 0.125)
                      for r, c in enumerate(q.chunk(sp, dim=2))])
    # sp(sp+1)/2 live pairs: the diagonal causal, the rest not
    assert sorted(calls) == [False] * 6 + [True] * 4


def _check(outs, cases, inp):
    for impl, config, causal, shape in cases:
        out, grads, counts = _jax(impl, config, causal, inp[shape])
        for o in outs:
            got = o[_key(impl, config, causal, shape)]
            np.testing.assert_allclose(got["out"].numpy(), out, **TOL)
            for g, w in zip(got["grads"], grads):
                np.testing.assert_allclose(g.numpy(), w, **TOL_GRAD)
            assert got["bytes"] == counts
            sp, r = config["sp"], got["sp_rank"]
            live = (r + 1 if causal else sp) if impl == "ring" else 0
            assert got["calls"] == ({"flash_attention_reference": live,
                                     "_bwd_dq_reference": live,
                                     "_bwd_dkv_reference": live}
                                    if live else {})


@pytest.mark.parametrize("case", FOUR,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_four_ranks_match_jax(four, case):
    inp, outs = four
    _check(outs, [case], inp)


@pytest.mark.parametrize("case", TWO,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_two_ranks_match_jax(two, case):
    inp, outs = two
    _check(outs, [case], inp)


@pytest.mark.parametrize("world", [2, 4])
def test_shape_outside_the_contract_raises_on_every_rank(two, four, world):
    # only a head dim past 256 is outside it: ragged chunks are padded and
    # head dims up to 256 padded to the kernels' widths
    _, outs = {2: two, 4: four}[world]
    for o in outs:
        big_head, odd_seq = o["contract"]
        assert "head dim 320 > 256" in big_head
        assert "must divide by sp" in odd_seq
    with pytest.raises(ValueError, match="head dim 320"):
        PR.check_ring_shape(96, 320)
    for n, dh in ((200, 64), (96, 128), (250, 48), (4000, 80), (96, 160),
                  (96, 256)):
        PR.check_ring_shape(n, dh)


@pytest.mark.parametrize("sp,causal,shape", [
    (4, True, (1000, 48)), (4, False, (1000, 80)), (2, True, (192, 80)),
    (2, False, (500, 48)), (4, False, (384, 48)), (2, True, (500, 80))])
def test_virtual_ring_ragged_matches_dense(sp, causal, shape):
    inp = {n: torch.from_numpy(a) for n, a in _inputs(sp, shape).items()}
    q, k, v, do = (inp[n] for n in ("q", "k", "v", "do"))
    chunks = [t.chunk(sp, dim=2) for t in (q, k, v, do)]
    scale = 1 / math.sqrt(shape[1])
    fwd = PR.drive_virtual([PR.ring_forward(
        chunks[0][r], chunks[1][r], chunks[2][r], r, sp, causal, scale)
        for r in range(sp)])
    bwd = PR.drive_virtual([PR.ring_backward(
        chunks[0][r], chunks[1][r], chunks[2][r], *fwd[r], chunks[3][r], r,
        sp, causal, scale) for r in range(sp)])
    out = torch.cat([o for o, _ in fwd], dim=2)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    want = PF.mha_reference(qs, ks, vs, causal=causal)
    np.testing.assert_allclose(out.numpy(), want.detach().numpy(), **TOL)
    got = [torch.cat(t, dim=2) for t in zip(*bwd)]
    for g, w in zip(got, torch.autograd.grad(want, (qs, ks, vs), do)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_no_mesh_is_mha_reference(impl, causal):
    inp = _inputs(3)
    q, k, v = (torch.from_numpy(inp[n]) for n in ("q", "k", "v"))
    got = getattr(PR, f"{impl}_attention")(q, k, v, causal=causal)
    want = j_mha(*(jnp.asarray(inp[n]) for n in ("q", "k", "v")),
                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, PF.mha_reference(q, k, v, causal))
