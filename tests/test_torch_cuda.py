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

import time

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,n,D", [(256, 250, 64), (384, 300, 128),
                                   (128, 100, 32), (4096, 4000, 128)])
def test_k1_k2_with_kv_len_match_plain_version(cuda, dtype, T, n, D):
    # keys at or past kv_len (here random, not zero) are masked: K1 and K2
    # against their plain versions, which mask them too, and K1 against
    # attention over the n real keys
    q, k, v = _qkv(cuda, dtype, T=T, D=D, seed=11)
    do = _qkv(cuda, dtype, T=T, D=D, seed=12)[0]
    scale = 1.0 / np.sqrt(D)
    before = (P.flash_attention.launches, P.flash_attention_bwd_dq.launches)
    out, lse = P.flash_attention_fwd(q, k, v, False, kv_len=n)
    dq, delta = P.flash_attention_bwd_dq(q, k, v, out, lse, do, False,
                                         kv_len=n)
    torch.cuda.synchronize()
    assert (P.flash_attention.launches,
            P.flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref_out, ref_lse = P.flash_attention_reference(q, k, v, False, scale,
                                                   kv_len=n)
    _close(out, ref_out, TOL[dtype])
    _close(lse, ref_lse, TOL_LSE)
    _close(out, P.mha_reference(q, k[:, :, :n], v[:, :, :n], False),
           TOL[dtype])
    ref_dq, ref_delta = P._bwd_dq_reference(q, k, v, out, lse, do, False,
                                            scale, 128, 128, kv_len=n)
    _close(dq, ref_dq, TOL_GRAD[dtype])
    _close(delta, ref_delta, TOL_LSE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80])
def test_padded_head_dim_launches_the_kernels(cuda, dtype, D):
    # Dh 48 and 80 run K1-K3 at 64 and 128 on zero-padded inputs: the
    # gradients against the plain versions at the original width
    q, k, v = _qkv(cuda, dtype, T=256, D=D, seed=13)
    do = _qkv(cuda, dtype, T=256, D=D, seed=14)[0]
    before = [f.launches for f in (P.flash_attention,
                                   P.flash_attention_bwd_dq,
                                   P.flash_attention_bwd_dkv)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = P.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [f.launches for f in (
        P.flash_attention, P.flash_attention_bwd_dq,
        P.flash_attention_bwd_dkv)] == [b + 1 for b in before]
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads)
    ref_out, ref_lse = P.flash_attention_reference(q, k, v, True)
    _close(out, ref_out, TOL[dtype])
    for got, want in zip(grads, P.flash_attention_bwd_reference(
            q, k, v, ref_out, ref_lse, do, True)):
        _close(got, want, TOL_GRAD[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [100, 256])
def test_wide_heads_launch_and_match_plain_versions(cuda, dtype, D, causal,
                                                    T):
    # head dims past 128 run K1-K3 at 256 (160 zero-padded), each kernel's
    # grid doubled and a block owning 128 of the output columns: O, lse
    # and the gradients against the plain versions, one launch of each
    q, k, v = _qkv(cuda, dtype, T=T, D=D, seed=17)
    do = _qkv(cuda, dtype, T=T, D=D, seed=18)[0]
    kernels = (P.flash_attention, P.flash_attention_bwd_dq,
               P.flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = P.flash_attention(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [b + 1 for b in before]
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads)
    _, lse = P.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = P.flash_attention_reference(q, k, v, causal)
    _close(out, ref_out, TOL[dtype])
    _close(lse, ref_lse, TOL_LSE)
    for got, want in zip(grads, P.flash_attention_bwd_reference(
            q, k, v, ref_out, ref_lse, do, causal)):
        _close(got, want, TOL_GRAD[dtype])


@pytest.mark.cuda
def test_head_dim_past_256_raises_on_the_card(cuda):
    q = torch.zeros((1, 2, 128, 320), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 320 > 256"):
        P.flash_attention(q, q, q)


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
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(), **tol)


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


# ---- the Llama family's shapes: grouped-query K/V and Dh=128 ----
# (tinyllama-1.1b's training and llama3-8b's forward shapes, cut in B and T
# to run in seconds; K/V are expanded from n_kv_head heads as
# models.llama.attention hands them to the kernels)

def _gqa_inputs(device, B, H, KV, T, D, seed):
    """q, k, v, dO [B, H, T, Dh] bf16 laid out as the Llama path makes them:
    transposed views of [B, T, H, Dh] tensors, k and v expanded from KV
    heads (query head h reads KV head h // (H // KV))."""
    from ray_tpu_torch.models.llama import expand_kv

    rng = np.random.default_rng(seed)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (B, T, heads, D), dtype=np.float32)).to(device, torch.bfloat16)

    q, k, v, do = draw(H), draw(KV), draw(KV), draw(H)
    k, v = expand_kv(k, H // KV), expand_kv(v, H // KV)
    return [t.transpose(1, 2) for t in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(32, 4, 64), (32, 8, 128)],
                         ids=["tinyllama-gqa8-dh64", "llama3-gqa4-dh128"])
def test_bf16_k1_k2_k3_at_llama_shapes(cuda, H, KV, D):
    q, k, v, do = _gqa_inputs(cuda, 1, H, KV, 512, D, seed=21)
    got, want = _k1_k3(q, k, v, do, True)
    for g, w, tol in zip(got, want, _tols(torch.bfloat16)):
        _close(g, w, tol)


def _llama_tiny_run(device, **kw):
    """llama-tiny in f32 from seeded CPU params: (logits, loss, grads)."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.preset("llama-tiny", dtype=torch.float32, **kw)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device=device)
    leaves = llama._gpt2._flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (2, 129))).to(device)
    logits = llama.forward(params, toks[:, :-1], cfg).detach()
    loss = llama.loss_fn(params, {"tokens": toks}, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits, loss.detach(), dict(zip(leaves, grads))


@pytest.mark.cuda
def test_llama_tiny_on_cuda_matches_cpu(cuda):
    # f32, flash with remat: K1-K3 on the card (their f32 route) against
    # their plain versions on the CPU, with cuBLAS's f32 products (no TF32)
    # against the CPU's. Logits atol=1e-4, rtol=1e-4; loss abs 1e-5;
    # gradients atol=1e-5, rtol=1e-4, the JAX parity tests' f32 bounds
    counters = (P.flash_attention, P.flash_attention_bwd_dq,
                P.flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    logits, loss, grads = _llama_tiny_run(cuda, attn_impl="flash", remat=True)
    torch.cuda.synchronize()
    # forward (2 layers), loss forward (2) and its remat recompute (2); the
    # backward's K2 and K3 once a layer
    assert [f.launches - b for f, b in zip(counters, before)] == [6, 2, 2]
    want = _llama_tiny_run("cpu", attn_impl="flash", remat=True)
    _close(logits, want[0], dict(atol=1e-4, rtol=1e-4))
    assert loss.item() == pytest.approx(want[1].item(), abs=1e-5)
    for key, g in grads.items():
        np.testing.assert_allclose(g.cpu().numpy(), want[2][key].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


# ------------------------------------------------ collectives and data parallel
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantize_on_card_bit_equal_to_cpu(cuda, dtype):
    # the same f32 bits in: q and scales bit-equal (IEEE division, round
    # half to even and the fp8 cast on both), and so is the dequantized sum
    from ray_tpu_torch.util.collective.quantize import (QuantizedAllreduce,
                                                        _dequantize_sum)

    q = QuantizedAllreduce(dtype=dtype, chunk=256)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        1 << 16).astype(np.float32))
    x[::97] *= 300.0
    got_q, got_s = q.quantize(x.to(cuda))
    want_q, want_s = q.quantize(x)
    assert torch.equal(got_q.cpu().view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(got_s.cpu(), want_s)
    stack = lambda t: torch.stack([t, t.flip(0)])
    assert torch.equal(_dequantize_sum(stack(got_q), stack(got_s)).cpu(),
                       _dequantize_sum(stack(want_q), stack(want_s)))


@pytest.mark.cuda
def test_nccl_world_one_module_ops(cuda, tmp_path):
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, "nccl", "card", store=str(tmp_path / "s"))
    try:
        x = torch.arange(1, 9, dtype=torch.float32, device=cuda)
        for op in col.ReduceOp:
            assert torch.equal(col.allreduce(x.clone(), op, "card"), x)
        assert torch.equal(col.broadcast(x.clone(), 0, "card"), x)
        assert torch.equal(col.allgather(None, x, "card")[0], x)
        assert torch.equal(col.reducescatter(x.view(1, 8), group_name="card"),
                           x)
        col.barrier("card")
        out = col.get_group("card").allreduce_device(x, average=True)
        assert out.is_cuda and torch.equal(out, x)
        with pytest.raises(ValueError, match="CUDA tensors"):
            col.allreduce(x.cpu(), group_name="card")
    finally:
        col.destroy_collective_group("card")


@pytest.mark.cuda
def test_world_one_dp_step_bit_equal_to_one_device(cuda, tmp_path):
    # gpt2-tiny f32 through a world-1 NCCL mesh: the sync's reduce-scatter
    # and all-gather are identities and dividing by 1 is exact, so losses
    # and params equal the one-device step's bit for bit; nothing moves
    # through the host
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import build_hierarchical_mesh
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util.collective._comm import HOST_STAGED
    from ray_tpu_torch.util.collective.hierarchy import Topology

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "default"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = build_hierarchical_mesh(topology=Topology(1, 1))
        cfg = gpt2.GPT2Config.preset("gpt2-tiny", dtype=torch.float32)
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, 512, (4, 33))).to(cuda)
        runs = []
        for m in (None, mesh):
            opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
            train = spmd.compile_gpt2_train(cfg, mesh=m, optimizer=opt)
            state = train.init_fn(torch.Generator().manual_seed(0))
            staged = HOST_STAGED["bytes"]
            losses = []
            for _ in range(3):
                state, met = train.step_fn(state, {"tokens": toks})
                losses.append(float(met["loss"]))
            runs.append((losses, state.params, HOST_STAGED["bytes"] - staged))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(spmd._leaves(runs[0][1]), spmd._leaves(runs[1][1])):
            assert torch.equal(a, b)
        assert runs[1][2] == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_across_cards(cuda, tmp_path):
    # two or four ranks, one card each, as two hosts: the quantized ring
    # (a send and a recv to the one peer each hop, also at 4 MiB a hop)
    # gives the gather exchange's bits; the fused int8 sync with error feedback gives, on
    # every rank, what the port's quantizer makes of the same inputs on the
    # CPU (the intra sums have two terms, so any order gives their bits);
    # gpt2-tiny data parallel holds every rank's params bit-equal and the
    # f32 trajectory within atol=1e-5, rtol=1e-4 of one device (the CPU
    # data-parallel tests' bound); nothing moves through the host
    import _torch_dist_workers as W
    from ray_tpu_torch.util.collective.quantize import (QuantizedAllreduce,
                                                        _dequantize_sum)

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one")
    world = 4 if n_cards >= 4 else 2
    intra, per = world // 2, 128 // (world // 2)
    rng = np.random.default_rng(11)
    v = rng.standard_normal((world, 128)).astype(np.float32)
    v[:, ::13] *= 40.0
    r = (rng.standard_normal((world, per)) * 1e-2).astype(np.float32)
    tokens = rng.integers(0, 512, (2 * world, 33))
    np.savez(tmp_path / "inputs.npz", v=v, r=r, tokens=tokens)
    outs = W.run_ranks(W.nccl_cards, world, str(tmp_path), timeout=300)

    q = QuantizedAllreduce(dtype="int8", chunk=16)
    vt, rt = torch.from_numpy(v), torch.from_numpy(r)
    host = vt.view(2, intra, 128).sum(1)            # [inter, 128]
    for rank, o in enumerate(outs):
        i, j = o["pos"]
        assert (i, j) == (rank // intra, rank % intra)
        assert o["grp_topology"] == (2, intra)
        cols = slice(j * per, (j + 1) * per)
        # the ring and the exchange take each member's own shard; the fused
        # sync takes its host's sum
        for key, src in (("ring", vt), ("gather", vt), ("sync_ef", host)):
            xs = [src[h if src is host else h * intra + j, cols]
                  + rt[h * intra + j] for h in range(2)]
            qs = [q.quantize(x) for x in xs]
            want = _dequantize_sum(torch.stack([a for a, _ in qs]),
                                   torch.stack([b for _, b in qs]))
            got, got_r = o[key]
            if key == "sync_ef":
                got = got[cols]
            assert torch.equal(got, want.reshape(-1)), (rank, key)
            assert torch.equal(got_r, q._residual(xs[i], *qs[i])), (rank, key)
        assert torch.equal(o["sync_ef"][0], outs[0]["sync_ef"][0])
        assert torch.equal(*o["ring_big"])
        np.testing.assert_allclose(o["sync_f32"].numpy(), v.sum(0),
                                   rtol=1e-6, atol=1e-5)
        assert torch.equal(o["dev_f32"], outs[0]["dev_f32"])
        assert torch.equal(o["dev_int8_ef"], outs[0]["dev_int8_ef"])
        assert o["staged"] == 0
    assert torch.equal(outs[1]["p2p"], torch.full((2, 2), 7.0))
    assert torch.equal(outs[0]["p2p"], torch.full((3,), 14.0))
    for name in ("f32", "int8-ef"):
        for o in outs[1:]:
            assert o[name][0] == outs[0][name][0], name
            for key, arr in o[name][1].items():
                assert arr.tobytes() == outs[0][name][1][key].tobytes()
    (h1, w1), (h2, w2) = outs[0]["one device"], outs[0]["f32"]
    np.testing.assert_allclose(np.array(h2), np.array(h1), atol=1e-5,
                               rtol=1e-4)
    for key, arr in w1.items():
        np.testing.assert_allclose(w2[key], arr, atol=1e-5, rtol=1e-4)
    assert np.isfinite(np.array(outs[0]["int8-ef"][0])).all()


@pytest.mark.cuda
def test_mesh_across_cards(cuda, tmp_path):
    # four ranks, one card each, over NCCL: gpt2-tiny on dp=2,tp=2 and
    # fsdp=2,tp=2 and moe-tiny on ep=4, 4 f32 steps within the CPU sharded
    # tests' bounds of one device (losses and grad norms atol=1e-5,
    # rtol=1e-4; params 1e-4); a bf16 step launches K1 twice (forward and
    # the remat recompute), K2 and K3 once per layer on every rank's local
    # [B/2, H/2] shard. Then chip_smoke's phase 6c (c) at full width over
    # NCCL on two of the cards: GPT-2-125M on tp=2 and fsdp=2 and the
    # mixtral-width MoE on ep=2 against one process, with its own gates
    import chip_smoke
    import _torch_dist_workers as W
    from ray_tpu_torch.train import spmd

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: one rank a card over NCCL")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 512, (4, 33))
    weights, refs = {}, {}
    for name in ("gpt2", "moe"):
        mod, cfg = W.family(name, attn_impl="dense")
        flat = mod.params_to_numpy(mod.init_params(
            torch.Generator().manual_seed(0), cfg, device="cpu"))
        weights.update({f"w/{name}/{k}": v for k, v in flat.items()})
        opt = spmd.default_optimizer(lr=1e-3, warmup=2, total_steps=20)
        train = spmd.compile_model_train(mod, cfg, optimizer=opt,
                                         device=cuda)
        params = mod.params_from_numpy(flat, cfg, device=cuda)
        state = spmd.TrainState(0, params, opt.init(params))
        hist = []
        for _ in range(4):
            state, m = train.step_fn(state, {"tokens": tokens})
            hist.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
        refs[name] = (hist, mod.params_to_numpy(state.params))
    np.savez(tmp_path / "inputs.npz", tokens=tokens, **weights)
    outs = W.run_ranks(W.mesh_cards, 4, str(tmp_path), timeout=600)
    for key, o in outs[0].items():
        if key == "bf16":
            continue
        (hist, params), (whist, wparams) = o, refs[key[0]]
        for (gl, gn, gs), (wl, wn, ws) in zip(hist, whist):
            assert gs == ws
            np.testing.assert_allclose(gl, wl, atol=1e-5, rtol=1e-4)
            np.testing.assert_allclose(gn, wn, atol=1e-5, rtol=1e-4)
        for k, arr in params.items():
            np.testing.assert_allclose(arr, wparams[k], atol=1e-4, rtol=0,
                                       err_msg=str((key, k)))
        for other in outs[1:]:
            assert other[key][0] == hist
    for o in outs:
        launches, loss, norm = o["bf16"]
        assert launches == (4, 2, 2) and np.isfinite(loss + norm)
    print(f"[mesh across cards] bf16 dp=2,tp=2 step launches by rank: "
          f"{[o['bf16'][0] for o in outs]}")
    (tmp_path / "pair").mkdir()
    paths = chip_smoke.mesh_pair(chip_smoke.gpu_line(),
                                 str(tmp_path / "pair"), "nccl")
    print(f"[mesh across cards] full width, rank 0's launches: {paths}")
    # the hierarchical mesh Topology(2, 1) x tp=2 on the four cards:
    # GPT-2-125M at global B=8 T=1024 against one process, same gates
    (tmp_path / "hier").mkdir()
    paths = chip_smoke.hier_cards(chip_smoke.gpu_line(),
                                  str(tmp_path / "hier"))
    print(f"[mesh across cards] hierarchical, rank 0's launches: {paths}")


@pytest.mark.cuda
def test_sp_across_cards(cuda, tmp_path):
    # two ranks, one card each, over NCCL (chip_smoke.sp_pair): GPT-2-125M
    # at full width, global B=8 T=1024, on sp=2 with ring and with Ulysses
    # attention, and tinyllama-1.1b at B=2 T=2048 on sp=2 with ring, each
    # within 0.01 loss and 2 % grad norm of one process on one card (flash),
    # with exact K1/K2/K3 launches a rank (sp rank r runs the ring's r + 1
    # live chunk pairs a layer; Ulysses runs none); then the GPT-2 ring
    # run's state, saved by both ranks, restores bit-equal on one card
    import chip_smoke

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one")
    paths = chip_smoke.sp_pair(chip_smoke.gpu_line(), str(tmp_path))
    print(f"[sp across cards] K1/K2/K3 launches by rank: {paths}")


@pytest.mark.cuda
def test_pp_across_cards(cuda, tmp_path):
    # GPipe over NCCL, one rank a card (chip_smoke.pp_cards): GPT-2-125M at
    # full width on pp=2 (B=24 T=1024, 8 microbatches, remat dots, 3 steps)
    # within 0.01 loss and 2 % grad norm of one process on one card; with
    # four cards, Llama-3-8B at full width and depth on pp=4 (B=8 T=2048, 8
    # microbatches, remat, 2 steps: step ms, tokens/s, MFU and peak memory
    # a rank printed), its first loss within 0.01 of one card's no-grad
    # loss_fn at the same weights and batch; and TinyLlama-1.1B on pp=2 x
    # sp=2 (B=4 T=4096, 4 microbatches, the ring running K1-K3 on chunk
    # pairs inside every stage) within 0.01 loss and 2 % grad norm of the
    # same first step on one card, its peak memory a rank printed beside
    # the prediction; exact K1/K2/K3 launches a rank, bubble ticks included
    import chip_smoke

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one")
    card = chip_smoke.gpu_line()
    paths = {}
    for fam in ("gpt2", "llama", "tinyllama-sp")[:1 + 2 * (n >= 4)]:
        (tmp_path / fam).mkdir()
        paths[fam] = chip_smoke.pp_cards(card, str(tmp_path / fam), fam)
    print(f"[pp across cards] K1/K2/K3 launches by rank: {paths}")


@pytest.mark.cuda
def test_tp_engine_across_cards(cuda):
    # the tensor-parallel engine over two cards (one process, a shard a
    # card) at chip_smoke phase 5's configuration against tp=1 on the
    # first: every sampled logits row up to the first parting within
    # chip_smoke.TOL_TP_LOGITS, streams equal but for near-ties under the
    # same bound; tok/s and TTFT of a burst on each printed
    import chip_smoke

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a shard on each")
    rec = chip_smoke.tp_engine_check(chip_smoke.gpu_line(),
                                     ["cuda:0", "cuda:1"])
    print(f"[tp engine across cards] {rec}")


# ---------------------------------------------------------------- runtime
@pytest.mark.cuda
def test_runtime_detects_gpus_without_being_told(cuda):
    # the head counts the cards (CUDA_VISIBLE_DEVICES, else NVML)
    # without importing torch; a num_gpus=1 task sees the card
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.resources import detect_num_gpus

    n = torch.cuda.device_count()
    assert detect_num_gpus() == n
    try:
        rt.init(num_cpus=2)
        assert rt.cluster_resources().get("GPU") == n

        @rt.remote(num_gpus=1)
        def where():
            import torch as _torch

            return _torch.cuda.is_available(), _torch.cuda.device_count()

        assert rt.get(where.remote(), timeout=300) == (True, n)
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_runtime_nccl_actor_group_across_cards(cuda):
    # two num_gpus=1 actors grouped by create_collective_group over NCCL:
    # each takes its own card (cuda:{local rank}) before the group is made,
    # and allreduce, broadcast and allgather of CUDA tensors give what
    # numpy gives of the same inputs (sums of two terms: exact); both
    # members destroy the group and the name is declared again with the
    # ranks reversed, with the same results by rank
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.collective import collective as col

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one")
    rng = np.random.default_rng(21)
    xs = [rng.standard_normal((4, 1024)).astype(np.float32) for _ in range(2)]

    class Member:
        def run(self, x):
            import torch as _torch

            from ray_tpu_torch.util.collective import collective as c

            c.get_group("nccl2")   # attaches: takes this member's card
            dev = _torch.cuda.current_device()
            t = _torch.from_numpy(x).to(_torch.device("cuda", dev))
            return {"allreduce": c.allreduce(t.clone(), group_name="nccl2"),
                    "broadcast": c.broadcast(t.clone(), src_rank=1,
                                             group_name="nccl2"),
                    "allgather": c.allgather(None, t, group_name="nccl2"),
                    "device": dev}

        def leave(self):
            from ray_tpu_torch.util.collective import collective as c

            c.destroy_collective_group("nccl2")
            return c.is_group_initialized("nccl2")

    try:
        rt.init(num_cpus=2)
        actors = [rt.remote(num_gpus=1)(Member).remote() for _ in xs]
        col.create_collective_group(actors, 2, [0, 1], backend="nccl",
                                    group_name="nccl2")
        got = rt.get([a.run.remote(x) for a, x in zip(actors, xs)],
                     timeout=300)
        assert rt.get([a.leave.remote() for a in actors],
                      timeout=120) == [False, False]
        col.create_collective_group(actors, 2, [1, 0], backend="nccl",
                                    group_name="nccl2")
        again = rt.get([a.run.remote(x) for a, x in zip(actors, xs[::-1])],
                       timeout=300)
    finally:
        rt.shutdown()
    assert sorted(g["device"] for g in got) == [0, 1]
    for g in got + again:
        np.testing.assert_array_equal(g["allreduce"].numpy(), xs[0] + xs[1])
        np.testing.assert_array_equal(g["broadcast"].numpy(), xs[1])
        np.testing.assert_array_equal(
            np.stack([p.numpy() for p in g["allgather"]]), np.stack(xs))


@pytest.mark.cuda
def test_gang_device_fetch_across_cards(cuda):
    # two num_gpus=1 actors in an NCCL group made by create_collective_group:
    # one put_devices a dict of CUDA tensors (f32 and bf16), a host tensor
    # and a string, the other gets it: the CUDA leaves arrive on the
    # getter's own card over NCCL (nothing staged through the host, no
    # snapshot staged by the owner), bit-equal; with the owner's sends
    # dropped (the chaos hook), the get raises ObjectLostError within
    # ici_fetch_timeout_s instead of hanging
    import ray_tpu_torch as rt

    from ray_tpu_torch.util.collective import collective as col

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one")

    class Member:
        def join(self):
            from ray_tpu_torch.util.collective import collective as c

            c.get_group("gang")   # attaches: takes this member's card
            return torch.cuda.current_device()

        def put(self):
            dev = torch.device("cuda", torch.cuda.current_device())
            g = torch.Generator(device=dev).manual_seed(5)
            self.value = {
                "w": torch.randn((64, 1024), generator=g, device=dev),
                "b": torch.randn((4096,), generator=g, device=dev).to(
                    torch.bfloat16),
                "host": torch.arange(10), "tag": "owner"}
            self._ref = rt.put_device(self.value)
            return self._ref.hex(), self.digests(self.value)

        @staticmethod
        def digests(value):
            return {k: (v.cpu().contiguous().view(-1).view(torch.uint8)
                        .numpy().tobytes() if isinstance(v, torch.Tensor)
                        else v) for k, v in value.items()}

        def get(self, hex_id, timeout_s=None):
            import time as _time

            from ray_tpu_torch.core import config as _config
            from ray_tpu_torch.core.exceptions import ObjectLostError
            from ray_tpu_torch.core.ids import ObjectID
            from ray_tpu_torch.core.object_ref import ObjectRef

            if timeout_s is not None:
                _config.GLOBAL.set("ici_fetch_timeout_s", timeout_s)
            t0 = _time.monotonic()
            try:
                val = rt.get(ObjectRef(ObjectID.from_hex(hex_id)),
                             timeout=300)
            except ObjectLostError as e:
                return {"lost": repr(e), "s": _time.monotonic() - t0}
            return {"devices": {k: str(v.device) for k, v in val.items()
                                if isinstance(v, torch.Tensor)},
                    "mine": f"cuda:{torch.cuda.current_device()}",
                    "digests": self.digests(val)}

        def drop_sends(self):
            from ray_tpu_torch.core import config as _config

            _config.GLOBAL.set("testing_ici_drop_send", True)
            return True

        def staged(self):
            from ray_tpu_torch.core import device_transport as dt
            from ray_tpu_torch.core.api import _global_client
            from ray_tpu_torch.util.collective._comm import HOST_STAGED

            return (dt.STATS["snapshots_staged"],
                    len(_global_client()._device_snapshots),
                    HOST_STAGED["bytes"])

    try:
        rt.init(num_cpus=2)
        a, b = [rt.remote(num_gpus=1)(Member).remote() for _ in range(2)]
        col.create_collective_group([a, b], 2, [0, 1], backend="nccl",
                                    group_name="gang")
        cards = rt.get([a.join.remote(), b.join.remote()], timeout=300)
        hex_id, want = rt.get(a.put.remote(), timeout=120)
        got = rt.get(b.get.remote(hex_id), timeout=300)
        staged = rt.get([a.staged.remote(), b.staged.remote()], timeout=60)
        assert rt.get(a.drop_sends.remote(), timeout=60)
        lost = rt.get(b.get.remote(hex_id, 10.0), timeout=300)
    finally:
        rt.shutdown()
    assert sorted(cards) == [0, 1]
    assert set(got["devices"]) == {"w", "b", "host"}
    assert got["devices"]["w"] == got["devices"]["b"] == got["mine"]
    assert got["devices"]["host"] == "cpu"
    assert got["digests"] == want
    assert staged == [(0, 0, 0), (0, 0, 0)], staged
    assert "never sent within 10.0s" in lost.get("lost", ""), lost
    assert lost["s"] < 30


@pytest.mark.cuda
def test_multinode_across_cards(cuda):
    # a head with no GPU and two node daemons naming two cards each
    # (CUDA_VISIBLE_DEVICES "0,1" and "2,3", num_gpus=2): a STRICT_SPREAD
    # group of {"GPU": 2, "CPU": 1} bundles puts one actor on each node;
    # the cards each sees are disjoint and together the machine's four;
    # the two form an NCCL group (one card each) whose allreduce and
    # broadcast are exact; one daemon killed, the other node's actor still
    # answers; nothing of the session is left after the shutdown
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import placement_group
    from ray_tpu_torch.util.collective import collective as col

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: two nodes of two")
    everyone = sorted(str(torch.cuda.get_device_properties(i).uuid)
                      for i in range(torch.cuda.device_count()))
    rng = np.random.default_rng(23)
    xs = [rng.standard_normal((4, 1024)).astype(np.float32) for _ in range(2)]

    class NodeMember:
        def cards(self):
            import os as _os

            import torch as _torch

            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    sorted(str(_torch.cuda.get_device_properties(i).uuid)
                           for i in range(_torch.cuda.device_count())))

        def run(self, x):
            import torch as _torch

            from ray_tpu_torch.util.collective import collective as c

            c.get_group("nodes2")   # attaches: takes this member's card
            dev = _torch.cuda.current_device()
            t = _torch.from_numpy(x).to(_torch.device("cuda", dev))
            return {"allreduce": c.allreduce(t.clone(), group_name="nodes2"),
                    "broadcast": c.broadcast(t.clone(), src_rank=1,
                                             group_name="nodes2"),
                    "uuid": str(_torch.cuda.get_device_properties(dev).uuid)}

        def ping(self):
            import os as _os

            return _os.getpid()

    c = Cluster(num_cpus=0)
    try:
        nodes = [c.add_node(num_cpus=2, num_gpus=2,
                            env={"CUDA_VISIBLE_DEVICES": vis})
                 for vis in ("0,1", "2,3")]
        c.connect()
        c.wait_for_nodes(3)
        assert rt.cluster_resources().get("GPU") == 4
        pg = placement_group([{"GPU": 2, "CPU": 1}] * 2,
                             strategy="STRICT_SPREAD")
        assert pg.ready(timeout=60)
        actors = [rt.remote(NodeMember).options(
            num_cpus=1, num_gpus=2, placement_group=pg,
            placement_group_bundle_index=i).remote() for i in range(2)]
        cards = rt.get([a.cards.remote() for a in actors], timeout=300)
        col.create_collective_group(actors, 2, [0, 1], backend="nccl",
                                    group_name="nodes2")
        got = rt.get([a.run.remote(x) for a, x in zip(actors, xs)],
                     timeout=300)
        c.kill_node(nodes[0])
        survivor = [a for a, (vis, _) in zip(actors, cards) if vis == "2,3"]
        assert len(survivor) == 1
        assert rt.get(survivor[0].ping.remote(), timeout=60) > 0
    finally:
        rt.shutdown()
        c.shutdown()
    assert c.processes() == [] and c.segments() == []
    assert sorted(vis for vis, _ in cards) == ["0,1", "2,3"]
    a_cards, b_cards = (set(u) for _, u in cards)
    assert len(a_cards) == len(b_cards) == 2 and not a_cards & b_cards
    assert sorted(a_cards | b_cards) == everyone
    assert got[0]["uuid"] != got[1]["uuid"]
    for g in got:
        np.testing.assert_array_equal(g["allreduce"].numpy(), xs[0] + xs[1])
        np.testing.assert_array_equal(g["broadcast"].numpy(), xs[1])


@pytest.mark.cuda
def test_compiled_pipeline_across_cards(cuda):
    # chip_smoke's phase 17 (b) model and batch (GPT-2-125M, 4 stages of 3
    # blocks, B=8 T=1024, M=4) across four cluster_utils daemons of one
    # card each (CUDA_VISIBLE_DEVICES), one stage actor on each, so every
    # ring crosses nodes: 3 compiled steps with host edges, then 3 with
    # device edges, each step within 0.01 loss of the same steps in this
    # process on one card; the stages on four distinct cards; nothing of
    # the session left after the shutdown (chip_smoke.compiled_pp_cards)
    import chip_smoke

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: one stage a card")
    everyone = sorted(str(torch.cuda.get_device_properties(i).uuid)
                      for i in range(torch.cuda.device_count()))
    out = chip_smoke.compiled_pp_cards(chip_smoke.gpu_line())
    assert sorted(out) == ["device", "host"]
    for kind, r in out.items():
        assert sorted(r["cards"]) == everyone, (kind, r["cards"])
        assert r["gap"] <= chip_smoke.TOL_TRAIN_LOSS, (kind, r["losses"])
        assert len(set(r["nodes"])) == 4 and r["rings"] == []


def _post_json(url, body, timeout=300):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.mark.cuda
def test_serve_openai_app_on_the_card(cuda):
    # build_openai_app on one num_gpus=1 replica, its engine on the card by
    # default (no device given): the greedy completion over HTTP equals the
    # same OpenAIServer's in this process on the card; nothing of the
    # session is left after serve.shutdown and the runtime's
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import OpenAIServer, build_openai_app

    engine = dict(preset="gpt2-125m", max_batch=2, max_seq_len=256, seed=0)
    body = {"prompt": "the serve plane on the card", "max_tokens": 16,
            "temperature": 0.0}
    local = OpenAIServer(model_id="m", **engine)
    try:
        class _Req:
            path, json = "/v1/completions", body

        want = local(_Req())["choices"][0]["text"]
    finally:
        local.shutdown()
    rt.init(num_cpus=4)
    try:
        assert rt.cluster_resources().get("GPU", 0) >= 1
        serve.run(build_openai_app(model_id="m", num_gpus=1, **engine),
                  route_prefix="/v1")
        port = serve.start()
        status, got = _post_json(f"http://127.0.0.1:{port}/v1/completions",
                                 body)
    finally:
        serve.shutdown()
        rt.shutdown()
    assert status == 200
    assert got["choices"][0]["text"] == want
    assert got["usage"]["completion_tokens"] == 16


@pytest.mark.cuda
def test_serve_replicas_across_cards(cuda):
    # two cluster_utils daemons of one card each (CUDA_VISIBLE_DEVICES "0"
    # and "1"), build_llm_deployment's two num_gpus=1 replicas one on each:
    # distinct card uuids, and the greedy tokens of each equal one card's
    # server in this process; nothing of the session left after shutdown
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.serve.llm import LLMServer

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one replica a card")
    engine = dict(preset="gpt2-125m", max_batch=2, max_seq_len=512, seed=0,
                  prefill_chunk_size=64)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 257, (n,), generator=g).tolist()
               for n in (96, 200)]
    local = LLMServer(**engine)
    try:
        want = [local({"prompt_ids": p, "max_tokens": 24})["choices"][0]
                ["token_ids"] for p in prompts]
    finally:
        local.shutdown()

    class CardServer(LLMServer):
        def card(self):
            import os as _os

            import torch as _torch

            dev = _torch.cuda.current_device()
            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    str(_torch.cuda.get_device_properties(dev).uuid))

    c = Cluster(num_cpus=0)
    try:
        for vis in ("0", "1"):
            c.add_node(num_cpus=2, num_gpus=1,
                       env={"CUDA_VISIBLE_DEVICES": vis})
        c.connect()
        c.wait_for_nodes(3)
        dep = serve.deployment(CardServer, name="cards", num_replicas=2,
                               ray_actor_options={"num_cpus": 1,
                                                  "num_gpus": 1})
        serve.run(dep.bind(**engine))
        table = rt.get(rt.get_actor("serve-controller")
                       .get_routing_table.remote("cards"), timeout=60)
        replicas = list(table["replicas"].values())
        cards = rt.get([r.handle_request.remote("card", (), {})
                        for r in replicas], timeout=300)
        got = [[rt.get(r.handle_request.remote(
                    "__call__", ({"prompt_ids": p, "max_tokens": 24},), {}),
                    timeout=300)["choices"][0]["token_ids"] for p in prompts]
               for r in replicas]
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()
    assert c.processes() == [] and c.segments() == []
    assert len(replicas) == 2
    assert sorted(vis for vis, _ in cards) == ["0", "1"]
    assert cards[0][1] != cards[1][1]
    assert got == [want, want]


@pytest.mark.cuda
def test_serve_compiled_scorer_on_the_card(cuda):
    # a scorer deployment served compiled (serve.run(..., compiled=True))
    # on two num_gpus=1 replicas of the card, each entry of the chain one
    # gpt2.forward (K1) over its requests: the logits over HTTP within 0.1
    # of the same forward in this process, the requests on the chain's
    # rings, its lanes over both replicas, K1 = 12 x forwards in each;
    # nothing of the session is left after the shutdowns
    import base64

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2

    T, n = 128, 8
    cfg = gpt2.GPT2Config.preset("gpt2-125m", attn_impl="flash",
                                 remat=False)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, 257, (T,), generator=g).tolist()
               for _ in range(n)]
    with torch.inference_mode():
        refs = [gpt2.forward(params, torch.tensor([p], device=cuda),
                             cfg)[0, -1].float().cpu() for p in prompts]
    del params

    class Scorer:
        def __init__(self):
            import torch as _torch

            from ray_tpu_torch.models import gpt2 as _gpt2
            from ray_tpu_torch.ops import flash_attention as _fa

            self.fa, self.gpt2 = _fa, _gpt2
            self.cfg = _gpt2.GPT2Config.preset("gpt2-125m",
                                               attn_impl="flash", remat=False)
            self.params = _gpt2.init_params(
                _torch.Generator().manual_seed(0), self.cfg, "cuda")
            self.forwards = 0
            self.fa.flash_attention.launches = 0

        def batch_call(self, requests):
            import base64 as _b64

            import torch as _torch

            ids = _torch.tensor([r.get("tokens") for r in requests],
                                device="cuda")
            with _torch.inference_mode():
                last = self.gpt2.forward(self.params, ids, self.cfg)[:, -1]
            self.forwards += 1
            return [{"logits": _b64.b64encode(
                row.float().cpu().numpy().tobytes()).decode()}
                for row in last]

        def __call__(self, request):
            return self.batch_call([request])[0]

        def counts(self):
            return self.forwards, self.fa.flash_attention.launches

    rt.init(num_cpus=4, num_gpus=2)
    try:
        serve.run(serve.deployment(Scorer, name="cscore", num_replicas=2,
                                   ray_actor_options={"num_gpus": 1},
                                   chain_config={
                                       "lanes": 2, "batch_max": 4,
                                       "channel_capacity": 4 << 20}).bind(),
                  route_prefix="/cscore", compiled=True)
        url = f"http://127.0.0.1:{serve.start()}/cscore"
        outs = [_post_json(url, {"tokens": prompts[0]})[1]]
        proxy = rt.get_actor("serve-proxy")
        deadline = time.time() + 120
        while not rt.get(proxy.chain_status.remote("cscore"),
                         timeout=60).get("live"):
            assert time.time() < deadline, "the chain never went live"
            time.sleep(0.1)
        outs += [_post_json(url, {"tokens": p})[1] for p in prompts]
        st = rt.get(proxy.chain_status.remote("cscore"), timeout=60)
        table = rt.get(rt.get_actor("serve-controller")
                       .get_routing_table.remote("cscore"), timeout=60)
        counts = [rt.get(r.handle_request.remote("counts", (), {}),
                         timeout=60) for r in table["replicas"].values()]
    finally:
        serve.shutdown()
        rt.shutdown()
    got = [torch.frombuffer(bytearray(base64.b64decode(o["logits"])),
                            dtype=torch.float32) for o in outs]
    for o, r in zip(got, refs[:1] + refs):
        assert float((o - r).abs().max()) <= 0.1
    assert st["stats"]["compiled"] >= n, st
    assert len({t for lane in st["lane_targets"] for _d, t in lane}) == 2
    assert len(counts) == 2 and all(f >= 1 for f, _ in counts)
    assert all(k1 == cfg.n_layer * f for f, k1 in counts), counts


@pytest.mark.cuda
def test_serve_disagg_across_cards(cuda):
    # build_disagg_llm_deployment with its prefill replica on a daemon of
    # card 0 and its decode replica on a daemon of card 1
    # (CUDA_VISIBLE_DEVICES "0" and "1", steered by resource labels): the
    # KV blob crosses nodes, the greedy tokens equal one card's server in
    # this process, and the replicas report distinct card uuids; nothing of
    # the session is left after the shutdowns
    import dataclasses

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.serve.disagg import (DisaggLLMServer, PrefillServer,
                                            build_disagg_llm_deployment)
    from ray_tpu_torch.serve.llm import LLMServer

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a pool a card")
    engine = dict(max_seq_len=512, seed=0, prefill_chunk_size=64,
                  kv_block_size=16, kv_blocks=64)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 257, (n,), generator=g).tolist()
               for n in (96, 200)]
    local = LLMServer(preset="gpt2-125m", max_batch=4, **engine)
    try:
        want = [local({"prompt_ids": p, "max_tokens": 24})["choices"][0]
                ["token_ids"] for p in prompts]
    finally:
        local.shutdown()

    def card(self):
        import os as _os

        import torch as _torch

        dev = _torch.cuda.current_device()
        return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                str(_torch.cuda.get_device_properties(dev).uuid))

    CardPrefill = type("CardPrefill", (PrefillServer,), {"card": card})
    CardDecode = type("CardDecode", (DisaggLLMServer,), {"card": card})
    app = build_disagg_llm_deployment(
        "gpt2-125m", name="xdisagg", num_gpus=1,
        prefill_resources={"prefill_pool": 1},
        decode_resources={"decode_pool": 1}, **engine)
    pre = dataclasses.replace(app.init_kwargs["prefill_handle"],
                              func_or_class=CardPrefill)
    app = dataclasses.replace(app, func_or_class=CardDecode, init_kwargs={
        **app.init_kwargs, "prefill_handle": pre})
    c = Cluster(num_cpus=0)
    try:
        nodes = {}
        for vis, pool in (("0", "prefill_pool"), ("1", "decode_pool")):
            nodes[pool] = c.add_node(num_cpus=2, num_gpus=1,
                                     resources={pool: 1},
                                     env={"CUDA_VISIBLE_DEVICES": vis})
        c.connect()
        c.wait_for_nodes(3)
        h = serve.run(app, name="xdisagg")
        got = [h.remote({"prompt_ids": p, "max_tokens": 24}).result(
            timeout=300)["choices"][0]["token_ids"] for p in prompts]
        st = h.stats.remote().result(timeout=60)
        cards = [h.card.remote().result(timeout=60),
                 serve.get_deployment_handle("xdisagg-prefill")
                 .card.remote().result(timeout=60)]
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()
    assert c.processes() == [] and c.segments() == []
    assert got == want
    assert st["prefill_fetches"] >= 2 and st["plane_fetches"] >= 1, st
    assert st["blocks_imported"] > 0, st
    assert sorted(vis for vis, _ in cards) == ["0", "1"]
    assert cards[0][1] != cards[1][1]


# the trainer across cards: GPT-2-125M at phase 6's configuration, global
# batch XC_B at T=XC_T from one Dataset, XC_STEPS steps
XC_PRESET, XC_B, XC_T, XC_STEPS = "gpt2-125m", 24, 1024, 3
XC_DEVICE = "cuda"


def _xc_corpus():
    """XC_STEPS global batches of Zipf-ranked tokens over the vocabulary."""
    from ray_tpu_torch.models import gpt2

    vocab = gpt2.GPT2Config.preset(XC_PRESET).vocab_size
    rng = np.random.default_rng(18)
    ranks = rng.zipf(1.2, (XC_B * XC_STEPS, XC_T + 1))
    return {"tokens": (np.minimum(ranks, vocab) - 1).astype(np.int32)}


def _xc_program(preset, mesh=None, device=None):
    """Phase 6's configuration of `preset` through compile_gpt2_train."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd

    cfg = gpt2.GPT2Config.preset(preset, attn_impl="flash", remat=True,
                                 remat_policy="dots", ce_chunk=0)
    opt = spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)
    return spmd.compile_gpt2_train(cfg, mesh=mesh, optimizer=opt,
                                   device=device)


def _xc_loop(config):
    """A rank of test_trainer_across_cards, in its worker: the dp mesh over
    the gang, each step's loss and this process's launches so far."""
    import importlib
    import os

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train import spmd

    importlib.import_module("torch.backends.cuda").matmul.allow_tf32 = False
    joined = train.maybe_init_distributed()
    ctx = train.get_context()
    mesh = build_mesh(MeshConfig(dp=ctx.get_world_size()),
                      device_type=config["device"])
    cfg = gpt2.GPT2Config.preset(config["preset"], attn_impl="flash",
                                 remat=True, remat_policy="dots", ce_chunk=0)
    prog = spmd.compile_gpt2_train(cfg, mesh=mesh, optimizer=(
        spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)))
    state = prog.init_fn(torch.Generator().manual_seed(0))
    bmesh, placements = prog.batch_sharding
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    for k in kernels:
        k.launches = 0
    hist = []
    for gi, batch in train.get_dataset_shard("train").iter_global_batches(
            batch_size=config["batch"]):
        if gi >= config["steps"]:
            break
        rows = torch.from_numpy(np.array(batch["tokens"])).to(prog.device)
        state, m = prog.step_fn(state, {"tokens": DTensor.from_local(
            rows, bmesh, placements)})
        hist.append([float(m["loss"])] + [k.launches for k in kernels])
    train.report({
        "hist": hist, "joined": joined, "rank": ctx.get_world_rank(),
        "local_rank": ctx.get_local_rank(),
        "current_device": (torch.cuda.current_device()
                           if torch.cuda.is_available() else None),
        "program_device": str(prog.device), "pid": os.getpid()})


@pytest.mark.cuda
def test_trainer_across_cards(cuda, tmp_path):
    # the port's SPMD trainer with two GPU workers of one node over NCCL:
    # each worker's card is cuda:<local rank> (distinct, the ranks' local
    # ranks 0 and 1), a dp=2 build_mesh mesh, the global batch of XC_B
    # rows (XC_B / 2 a rank) from one Dataset; every step's loss within
    # 0.01 of a world-1 run in this process on the same global batches,
    # and K1/K2/K3 24/12/12 a step counted in each rank's process
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train
    from ray_tpu_torch.train.controller import TrainControllerLogic
    from ray_tpu_torch.train.ingest import DatasetShard

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a worker a card")

    class Keeping(TrainControllerLogic):
        reports = {}

        def _drain(self, statuses, group):
            for rank, st in enumerate(statuses):
                Keeping.reports.setdefault(rank, []).extend(
                    r["metrics"] for r in st["reports"])
            return super()._drain(statuses, group)

    rt.init(num_cpus=8, num_gpus=2)
    try:
        ds = rd.from_numpy(_xc_corpus(), parallelism=4).random_shuffle(
            seed=0)
        batches = [np.array(b["tokens"]) for gi, b in DatasetShard(
            ds, 0, 1).iter_global_batches(batch_size=XC_B)][:XC_STEPS]
        # world 1 in this process, freed before the workers start
        prog = _xc_program(XC_PRESET, device=XC_DEVICE)
        state = prog.init_fn(torch.Generator().manual_seed(0))
        want = []
        for rows in batches:
            state, m = prog.step_fn(state, {"tokens": torch.from_numpy(
                rows).to(XC_DEVICE)})
            want.append(float(m["loss"]))
        del prog, state
        torch.cuda.empty_cache()
        out = Keeping(
            _xc_loop, {"device": XC_DEVICE, "preset": XC_PRESET,
                       "batch": XC_B, "steps": XC_STEPS},
            train.ScalingConfig(num_workers=2,
                                use_gpu=XC_DEVICE == "cuda"),
            train.RunConfig(name="xcards", storage_path=str(tmp_path)),
            backend=train.SpmdBackend(),
            datasets={"train": ds}).run()
    finally:
        rt.shutdown()
    assert out["state"] == "FINISHED", out["error"]
    got = {rank: reps[-1] for rank, reps in Keeping.reports.items()}
    assert sorted(got) == [0, 1]
    assert all(g["joined"] for g in got.values())
    assert [got[r]["local_rank"] for r in (0, 1)] == [0, 1]
    assert got[0]["pid"] != got[1]["pid"]
    if XC_DEVICE == "cuda":
        assert [got[r]["current_device"] for r in (0, 1)] == [0, 1]
        assert [got[r]["program_device"] for r in (0, 1)] == [
            "cuda:0", "cuda:1"]
    from ray_tpu_torch.models import gpt2

    n_layer = gpt2.GPT2Config.preset(XC_PRESET).n_layer
    gaps = []
    for rank in (0, 1):
        hist = got[rank]["hist"]
        assert len(hist) == XC_STEPS
        for i, (loss, k1, k2, k3) in enumerate(hist):
            gaps.append(abs(loss - want[i]))
            assert gaps[-1] <= 0.01, (rank, i, loss, want[i])
            assert (k1, k2, k3) == ((i + 1) * 2 * n_layer,
                                    (i + 1) * n_layer, (i + 1) * n_layer)
    print(f"trainer across cards: world-1 losses {want}; rank losses "
          f"{[[h[0] for h in got[r]['hist']] for r in (0, 1)]}; max "
          f"|dloss| {max(gaps):.3g}")


@pytest.mark.cuda
def test_tune_half_gpu_trials_share_the_card(cuda, tmp_path):
    # two {"GPU": 0.5} trials of the port's Tuner on a node of one GPU:
    # both alive at once (each waits for the other's start file before it
    # runs), each launching K1 on the card in its own process
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    import _torch_tune_loops as loops
    from ray_tpu_torch.models import gpt2

    rt.init(num_cpus=4, num_gpus=1)
    try:
        grid = tune.Tuner(
            tune.with_resources(loops.gpu_trial, {"CPU": 1, "GPU": 0.5}),
            param_space={"me": tune.grid_search(["a", "b"]),
                         "dir": str(tmp_path)},
            tune_config=tune.TuneConfig(metric="met", mode="max",
                                        max_concurrent_trials=2),
            run_config=RunConfig(name="card-halves",
                                 storage_path=str(tmp_path))).fit()
    finally:
        rt.shutdown()
    n_layer = gpt2.GPT2Config.preset("gpt2-tiny").n_layer
    assert [r.error for r in grid.results] == [None, None]
    for r in grid.results:
        m = r.metrics
        assert m["met"] == 1 and m["finite"], m
        assert m["device"].startswith("cuda") and m["launches"] == n_layer
    assert len({r.metrics["pid"] for r in grid.results}) == 2


@pytest.mark.cuda
def test_ppo_update_on_the_card_matches_the_cpu(cuda):
    # one PPO update on a CartPole fragment (16 Adam steps) with the
    # learner on the card against the same update on the CPU, from the
    # same params and fragment: chip_smoke's TOL_PPO_UPDATE and PPO_FLIPS
    from chip_smoke import PPO_FLIPS, TOL_PPO_UPDATE, _ppo_config
    from ray_tpu_torch.rllib.core.rl_module import flatten

    card, cpu = _ppo_config("cuda").build(), _ppo_config("cpu").build()
    assert card.learner.device.type == "cuda"
    assert card.env_runner_group.local.device.type == "cuda"
    cpu.learner.set_weights(card.learner.get_weights())
    frag = card.env_runner_group.sample(128)[0]
    frag.pop("_metrics")
    frag.pop("next_obs")
    mc = card._ppo_update_on_fragment(card.learner, dict(frag),
                                      np.random.default_rng(0))
    mp = cpu._ppo_update_on_fragment(cpu.learner, dict(frag),
                                     np.random.default_rng(0))
    a, b = (np.concatenate([x.ravel() for x in flatten(
        algo.learner.get_weights()).values()]) for algo in (card, cpu))
    d = np.abs(a - b)
    assert int((d > TOL_PPO_UPDATE).sum()) <= PPO_FLIPS, d.max()
    assert d.max() <= 2 * 3e-4 * 16
    assert abs(mc["total_loss"] - mp["total_loss"]) < 1e-4
    card.stop(); cpu.stop()
