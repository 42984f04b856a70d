"""ray_tpu_torch.ops.flash_attention against the JAX reference.

The same numpy inputs go through the JAX package (the Pallas K1 in interpret
mode, as its own tests run it off-TPU, and its mha_reference) and through the
port's plain versions, which the port's wrapper takes for CPU tensors.
Tolerances are the reference kernel test's: atol=2e-5, rtol=1e-4 in f32.
The CUDA kernel's own tests are in test_torch_cuda.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

J = importlib.import_module("ray_tpu.ops.flash_attention")
P = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(B=2, H=4, T=256, Tk=None, D=64, seed=0):
    rng = np.random.default_rng(seed)
    Tk = Tk or T
    return (rng.standard_normal((B, H, T, D), dtype=np.float32),
            rng.standard_normal((B, H, Tk, D), dtype=np.float32),
            rng.standard_normal((B, H, Tk, D), dtype=np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("causal,T,D", [(True, 256, 64), (False, 128, 64),
                                        (True, 128, 32), (True, 96, 128)])
def test_plain_k1_matches_pallas_kernel(causal, T, D):
    q, k, v = _qkv(T=T, D=D)
    scale = 1.0 / np.sqrt(D)
    j_out, j_lse = J._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, scale, 128, 128)
    out, lse = P.flash_attention_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)
    assert lse.shape == (2, 4, T) and lse.dtype == torch.float32
    ref = P.flash_attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_array_equal(ref[0].numpy(), out.numpy())


@pytest.mark.parametrize("causal,T,Tk", [(True, 256, 256), (False, 128, 128),
                                         (True, 64, 128), (False, 64, 256)])
def test_mha_reference_matches_jax(causal, T, Tk):
    q, k, v = _qkv(T=T, Tk=Tk)
    want = J.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal)
    got = P.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,T", [(True, 256), (False, 128)])
def test_flash_matches_mha_reference(causal, T):
    q, k, v = _qkv(T=T, seed=3)
    got = P.flash_attention(*_t(q, k, v), causal)
    want = P.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_flash_rejects_indivisible_seq():
    q, k, v = _t(*_qkv(T=130))
    with pytest.raises(ValueError, match="divide"):
        P.flash_attention(q, k, v)


def test_flash_rejects_causal_unequal_lengths():
    # the Pallas kernel (diagonal at 0) and mha_reference (diagonal at
    # Tk - Tq) disagree here; the port refuses rather than pick one
    q, k, v = _t(*_qkv(T=128, Tk=256))
    with pytest.raises(ValueError, match="Tq == Tk"):
        P.flash_attention(q, k, v, True)
    out = P.flash_attention(q, k, v, False)   # non-causal is well defined
    np.testing.assert_allclose(out.numpy(), P.mha_reference(
        q, k, v, causal=False).numpy(), **TOL)


def test_flash_rejects_unsupported_head_dim():
    q, k, v = _t(*_qkv(T=64, D=48))
    with pytest.raises(ValueError, match="head dim"):
        P.flash_attention(q, k, v)


def test_flash_cpu_takes_plain_version_without_counting():
    q, k, v = _t(*_qkv(T=64))
    before = P.flash_attention.launches
    P.flash_attention(q, k, v)
    assert P.flash_attention.launches == before


def test_flash_refuses_other_devices():
    q = torch.empty((1, 1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        P.flash_attention(q, q, q)


def test_flash_bf16_plain_version_close_to_f32():
    # bf16 inputs: the plain version computes in f32 and rounds O once, so
    # it stays within a bf16 step (2^-8 relative) of the f32 result on the
    # same (bf16-representable) inputs
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(T=128, seed=5)))
    out, lse = P.flash_attention_fwd(q, k, v)
    out32, lse32 = P.flash_attention_fwd(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), out32.numpy(),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), **TOL)
