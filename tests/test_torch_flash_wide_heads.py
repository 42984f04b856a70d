"""Head dims past 128 in the port's flash attention and ring, against the
JAX package's.

The kernels are built for head dims up to 256: a head dim in (128, 256] is
zero-padded to 256 (each CUDA kernel's grid then doubles, a block owning 128
of the output columns), and the plain versions take the same padding. Here,
on the CPU, the same seeded numpy inputs at B=1 H=2 T=256, f32, go through:

- the JAX package's Pallas K1 (`_fwd`, interpret mode off-TPU) and the
  port's plain K1, forward within atol=2e-5, rtol=1e-4 (the reference
  kernel test's, tests/test_ops_attention.py), at Dh 160 and 256, causal
  and not;
- JAX's `flash_attention` gradients (Pallas K2 and K3 in interpret mode)
  and the port's autograd Function (plain K2 then K3), within atol=5e-4,
  rtol=1e-3;
- the port's ring schedule driven for sp=2 virtual ranks at Dh=160 against
  JAX's ring math (`_chunk_update` over each rank's chunks in ring order,
  as `ring_attention_local` runs it) and its gradients by `jax.grad`.

Past 256 both the wrapper and the ring raise (tests/test_torch_flash_
attention.py, tests/test_torch_ring_attention.py). The CUDA kernels at
Dh=256 and 160 are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py's phase 2).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

J = importlib.import_module("ray_tpu.ops.flash_attention")
JR = importlib.import_module("ray_tpu.ops.ring_attention")
P = importlib.import_module("ray_tpu_torch.ops.flash_attention")
PR = importlib.import_module("ray_tpu_torch.ops.ring_attention")

TOL = dict(atol=2e-5, rtol=1e-4)
TOL_GRAD = dict(atol=5e-4, rtol=1e-3)
B, H, T = 1, 2, 256


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D), dtype=np.float32)
            for _ in range(4)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_k1_matches_pallas_kernel(D, causal):
    q, k, v, _ = _inputs(D, seed=D)
    scale = 1.0 / math.sqrt(D)
    j_out, j_lse = J._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, scale, 128, 128)
    out, lse = P.flash_attention_fwd(*_t(q, k, v), causal=causal)
    assert out.shape == (B, H, T, D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax(D, causal):
    q, k, v, do = _inputs(D, seed=D + 1)

    def jloss(q, k, v):
        return jnp.sum(J.flash_attention(q, k, v, causal) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = P.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (B, H, T, D), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD,
                                   err_msg=f"d{name}")


def _jax_ring(q, k, v, sp, causal, scale):
    """JAX's ring math for sp ranks in one process: rank r holds q's chunk r
    and merges the K/V chunks r, r - 1, ... in ring order with
    `_chunk_update`, then divides by l (ring_attention_local's steps without
    the ppermutes)."""
    n = q.shape[2] // sp
    outs = []
    for r in range(sp):
        qc = q[:, :, r * n:(r + 1) * n]
        m = jnp.full((*qc.shape[:3], 1), JR.NEG_INF, jnp.float32)
        l = jnp.zeros((*qc.shape[:3], 1), jnp.float32)
        acc = jnp.zeros(qc.shape, jnp.float32)
        for step in range(sp):
            src = (r - step) % sp
            m, l, acc = JR._chunk_update(
                qc, k[:, :, src * n:(src + 1) * n],
                v[:, :, src * n:(src + 1) * n], m, l, acc, scale,
                q_off=r * n, k_off=src * n, causal=causal)
        outs.append(acc / jnp.maximum(l, 1e-30))
    return jnp.concatenate(outs, axis=2)


@pytest.mark.parametrize("causal", [True, False])
def test_virtual_ring_dh160_matches_jax_ring(causal):
    sp, D = 2, 160
    q, k, v, do = _inputs(D, seed=7)
    scale = 1.0 / math.sqrt(D)
    chunks = [t.chunk(sp, dim=2) for t in _t(q, k, v, do)]
    fwd = PR.drive_virtual([PR.ring_forward(
        chunks[0][r], chunks[1][r], chunks[2][r], r, sp, causal, scale)
        for r in range(sp)])
    bwd = PR.drive_virtual([PR.ring_backward(
        chunks[0][r], chunks[1][r], chunks[2][r], *fwd[r], chunks[3][r], r,
        sp, causal, scale) for r in range(sp)])
    out = torch.cat([o for o, _ in fwd], dim=2)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = _jax_ring(jq, jk, jv, sp, causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    want_grads = jax.grad(
        lambda *t: jnp.sum(_jax_ring(*t, sp, causal, scale) * do),
        argnums=(0, 1, 2))(jq, jk, jv)
    got = [torch.cat(t, dim=2) for t in zip(*bwd)]
    for name, g, w in zip("qkv", got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD,
                                   err_msg=f"d{name}")
