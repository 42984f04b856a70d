"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false: a CUDA kernel has no CPU mode. This file imports neither JAX nor
the JAX package, so it also runs on a card's host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: forward in f32, the reference kernel test's atol=2e-5,
rtol=1e-4; gradients in f32, its atol=5e-4, rtol=1e-3; bf16, one bf16 step
(2^-8 relative) of the value, as 1e-2 + 1e-2*|ref|, since kernel and plain
version both compute in f32 and round once; lse and Delta are f32 in both.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as P

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
TOL_LSE = dict(atol=1e-4, rtol=1e-5)
TOL_GRAD = {torch.float32: dict(atol=5e-4, rtol=1e-3),
            torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, dtype, B=2, H=4, T=256, Tk=None, D=64, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(B, H, T, D)] + [(B, H, Tk or T, D)] * 2
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,T,Tk,D", [
    (True, 256, 256, 64), (False, 128, 128, 32), (True, 200, 200, 128),
    (False, 64, 256, 64), (True, 1024, 1024, 64)])
def test_k1_matches_plain_version(cuda, dtype, causal, T, Tk, D):
    q, k, v = _qkv(cuda, dtype, T=T, Tk=Tk, D=D)
    before = P.flash_attention.launches
    out, lse = P.flash_attention_fwd(q, k, v, causal, block_q=T, block_k=Tk)
    torch.cuda.synchronize()
    assert P.flash_attention.launches == before + 1
    assert out.dtype == dtype and lse.shape == (2, 4, T)
    ref_out, ref_lse = P.flash_attention_reference(q, k, v, causal)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref_out.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               **TOL_LSE)


@pytest.mark.cuda
def test_k1_takes_strided_inputs(cuda):
    # q/k/v as the model makes them: views of one [B, T, 3, H, Dh] buffer
    B, T, H, D = 2, 128, 4, 64
    qkv = torch.randn((B, T, 3, H, D), device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = P.flash_attention(q, k, v)
    want = P.flash_attention(*(t.contiguous() for t in (q, k, v)))
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,T,Tk,D", [
    (True, 256, 256, 64), (False, 128, 128, 32), (True, 200, 200, 128),
    (False, 64, 256, 64), (True, 1024, 1024, 64)])
def test_k2_k3_match_plain_version(cuda, dtype, causal, T, Tk, D):
    q, k, v = _qkv(cuda, dtype, T=T, Tk=Tk, D=D)
    do = _qkv(cuda, dtype, T=T, D=D, seed=8)[0]
    out, lse = P.flash_attention_fwd(q, k, v, causal, block_q=T, block_k=Tk)
    before = (P.flash_attention_bwd_dq.launches,
              P.flash_attention_bwd_dkv.launches)
    dq, delta = P.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                         block_q=T, block_k=Tk)
    dk, dv = P.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                       block_q=T, block_k=Tk)
    torch.cuda.synchronize()
    assert (P.flash_attention_bwd_dq.launches,
            P.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    ref = P.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                          None, T, Tk)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want, TOL_GRAD[dtype])
    _close(delta, (do.float() * out.float()).sum(-1), TOL_LSE)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_k1_k2_k3_grads_match_mha_reference(cuda, causal):
    # dO as autograd hands it over after transpose(1, 2).reshape: a strided
    # view, read by the kernels through its strides
    B, H, T, D = 2, 4, 256, 64
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, torch.float32, T=T))
    do = torch.randn((B, T, H, D), device=cuda).transpose(1, 2)
    grads = [torch.autograd.grad(fn(q, k, v, causal), (q, k, v), do)
             for fn in (P.flash_attention, P.mha_reference)]
    for got, want in zip(*grads):
        _close(got, want, TOL_GRAD[torch.float32])


@pytest.mark.cuda
def test_backward_launches_each_kernel_once(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, torch.bfloat16, T=128))
    counters = (P.flash_attention, P.flash_attention_bwd_dq,
                P.flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    P.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_k2_k3_take_strided_inputs(cuda):
    # the same values laid out as the model makes them: bit-equal gradients
    B, T, H, D = 2, 128, 4, 64
    qkv = torch.randn((B, T, 3, H, D), device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((B, T, H, D), device=cuda).transpose(1, 2)
    out, lse = P.flash_attention_fwd(q, k, v)
    got = P.flash_attention_bwd(q, k, v, out, lse, do)
    want = P.flash_attention_bwd(*(t.contiguous() for t in (q, k, v)), out,
                                 lse, do.contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
def test_k1_refuses_other_dtypes(cuda):
    q, k, v = _qkv(cuda, torch.float16, T=64)
    with pytest.raises(TypeError):
        P.flash_attention(q, k, v)


# ---- the tensor-core bodies (bf16 K1, K2, K3) and the f32 FMA route ----
# bf16 K1 rounds P, bf16 K2 dS, and bf16 K3 P^T and dS^T, to bf16 before a
# product with f32 accumulation (about 2^-9 relative per term, random in
# sign): well inside the bf16 tolerances above, which stay as they are.

def _k1_k3(q, k, v, do, causal):
    """K1, K2 and K3 on the card, then their plain versions on the same
    inputs (K2's takes the kernels' O and lse, K3's their lse and Delta):
    ((out, lse, dq, delta, dk, dv), the same from the plain versions)."""
    T, D = q.shape[2], q.shape[3]
    out, lse = P.flash_attention_fwd(q, k, v, causal, block_q=T, block_k=T)
    dq, delta = P.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                         block_q=T, block_k=T)
    dk, dv = P.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                       block_q=T, block_k=T)
    torch.cuda.synchronize()
    ref_out, ref_lse = P.flash_attention_reference(q, k, v, causal)
    ref_dq, ref_delta = P._bwd_dq_reference(q, k, v, out, lse, do, causal,
                                            D ** -0.5, T, T)
    ref_dk, ref_dv = P._bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                          D ** -0.5, T, T)
    return ((out, lse, dq, delta, dk, dv),
            (ref_out, ref_lse, ref_dq, ref_delta, ref_dk, ref_dv))


def _tols(dtype):
    """_k1_k3's tolerances, output by output."""
    return (TOL[dtype], TOL_LSE, TOL_GRAD[dtype], TOL_LSE, TOL_GRAD[dtype],
            TOL_GRAD[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [100, 384])
def test_bf16_k1_k3_match_plain_version(cuda, D, causal, T):
    # T=100: ragged q and key tiles at both ends; 384: several tiles.
    # K2 is held against its plain version here too
    q, k, v = _qkv(cuda, torch.bfloat16, B=2, H=3, T=T, D=D, seed=11)
    do = _qkv(cuda, torch.bfloat16, B=2, H=3, T=T, D=D, seed=12)[0]
    got, want = _k1_k3(q, k, v, do, causal)
    out, _, dq, _, dk, dv = got
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for g, w, tol in zip(got, want, _tols(torch.bfloat16)):
        _close(g, w, tol)


@pytest.mark.cuda
def test_bf16_k1_k3_take_model_layout(cuda):
    # q/k/v split from one [B, T, 3D] tensor and dO a transposed [B, T, D]
    # gradient, as the model and autograd hand them over: read in place
    B, T, H, D = 2, 256, 4, 64
    qkv = torch.randn((B, T, 3 * H * D), device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2)
               for t in qkv.split(H * D, dim=-1))
    do = torch.randn((B, T, H * D), device=cuda).to(torch.bfloat16)
    do = do.reshape(B, T, H, D).transpose(1, 2)
    got, want = _k1_k3(q, k, v, do, True)
    for g, w, tol in zip(got, want, _tols(torch.bfloat16)):
        _close(g, w, tol)
    contiguous = _k1_k3(*(t.contiguous() for t in (q, k, v, do)), True)[0]
    for g, c in zip(got, contiguous):
        torch.testing.assert_close(g, c, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_k3_is_deterministic(cuda, D):
    q, k, v = _qkv(cuda, torch.bfloat16, B=2, H=4, T=512, D=D, seed=13)
    do = _qkv(cuda, torch.bfloat16, B=2, H=4, T=512, D=D, seed=14)[0]
    out, lse = P.flash_attention_fwd(q, k, v, True)
    _, delta = P.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    first = P.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    second = P.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_k2_is_deterministic(cuda, D):
    q, k, v = _qkv(cuda, torch.bfloat16, B=2, H=4, T=512, D=D, seed=19)
    do = _qkv(cuda, torch.bfloat16, B=2, H=4, T=512, D=D, seed=20)[0]
    out, lse = P.flash_attention_fwd(q, k, v, True)
    first = P.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    second = P.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_f32_stays_on_the_fma_route(cuda):
    # f32 inputs that bf16 cannot hold: the f32 route matches the plain
    # version at the reference's f32 tolerances, which a product in bf16
    # (or TF32) misses, as the same inputs rounded to bf16 show
    q, k, v = _qkv(cuda, torch.float32, B=2, H=4, T=256, D=64, seed=15)
    do = _qkv(cuda, torch.float32, B=2, H=4, T=256, D=64, seed=16)[0]
    got, want = _k1_k3(q, k, v, do, True)
    for g, w, tol in zip(got, want, _tols(torch.float32)):
        _close(g, w, tol)
    rounded = [t.to(torch.bfloat16).float() for t in (q, k, v)]
    with pytest.raises(AssertionError):
        _close(P.flash_attention_fwd(*rounded, True)[0], want[0],
               TOL[torch.float32])
