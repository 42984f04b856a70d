"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false: a CUDA kernel has no CPU mode. This file imports neither JAX nor
the JAX package, so it also runs on a card's host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: f32, the reference kernel test's atol=2e-5, rtol=1e-4; bf16,
one bf16 step (2^-8 relative) of |O|, as 1e-2 + 1e-2*|ref|; lse is f32 in
both versions.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as P

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
TOL_LSE = dict(atol=1e-4, rtol=1e-5)


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


@pytest.mark.cuda
def test_k1_refuses_grad(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, torch.float32, T=64))
    with pytest.raises(NotImplementedError, match="training slice"):
        P.flash_attention(q, k, v)
    with torch.no_grad():
        P.flash_attention(q, k, v)


@pytest.mark.cuda
def test_k1_refuses_other_dtypes(cuda):
    q, k, v = _qkv(cuda, torch.float16, T=64)
    with pytest.raises(TypeError):
        P.flash_attention(q, k, v)
