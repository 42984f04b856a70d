"""ray_tpu_torch.ops.flash_attention against the JAX reference.

The same numpy inputs go through the JAX package (the Pallas K1, K2 and K3 in
interpret mode, as its own tests run them off-TPU, and its mha_reference) and
through the port's plain versions, which the port's wrappers take for CPU
tensors. Tolerances are the reference kernel test's: forward atol=2e-5,
rtol=1e-4 and gradients atol=5e-4, rtol=1e-3 in f32
(tests/test_ops_attention.py). The CUDA kernels' own tests are in
test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

J = importlib.import_module("ray_tpu.ops.flash_attention")
P = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=1e-4)
TOL_GRAD = dict(atol=5e-4, rtol=1e-3)


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
    # head dims up to 256 are padded to the kernels' widths; past 256 no
    # kernel is built
    q, k, v = _t(*_qkv(T=64, D=320))
    with pytest.raises(ValueError, match="head dim 320 > 256"):
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


# ------------------------------------------------------------- backward


def _fwd_bwd_inputs(T, D, seed):
    q, k, v = _qkv(T=T, D=D, seed=seed)
    do = np.random.default_rng(seed + 100).standard_normal(
        q.shape, dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D,bq,bk", [(128, 32, 64, 128), (256, 64, 128, 64),
                                       (256, 32, 64, 64), (128, 64, 128, 128)])
def test_plain_k2_k3_match_pallas_kernels(causal, T, D, bq, bk):
    # blocks of 64 and 128 over T of 128 and 256: several blocks on each
    # side, k-block frontiers and q-block causal starts that differ
    q, k, v, do = _fwd_bwd_inputs(T, D, seed=11)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_out, j_lse = J._fwd(jq, jk, jv, causal, scale, bq, bk)
    want = J._bwd(causal, scale, bq, bk, (jq, jk, jv, j_out, j_lse),
                  jnp.asarray(do))
    out, lse = _t(np.array(j_out), np.array(j_lse)[..., 0])
    got = P.flash_attention_bwd_reference(*_t(q, k, v), out, lse, *_t(do),
                                          causal, scale, bq, bk)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD,
                                   err_msg=f"d{name}")
    # K2 alone returns Delta = rowsum(dO * O), JAX's `delta` without its
    # trailing lane dim
    _, delta = P.flash_attention_bwd_dq(*_t(q, k, v), out, lse, *_t(do),
                                        causal, scale, bq, bk)
    np.testing.assert_allclose(
        delta.numpy(), (do * np.asarray(j_out)).sum(-1), **TOL)


@pytest.mark.parametrize("causal,T,D", [(True, 256, 64), (False, 128, 32),
                                        (True, 128, 128)])
def test_flash_grads_match_jax(causal, T, D):
    q, k, v, do = _fwd_bwd_inputs(T, D, seed=12)

    def jloss(q, k, v):
        return jnp.sum(J.flash_attention(q, k, v, causal) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = P.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_mha_reference_autograd(causal):
    q, k, v, do = _fwd_bwd_inputs(128, 64, seed=13)
    grads = []
    for fn in (P.flash_attention, P.mha_reference):
        tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
        grads.append(torch.autograd.grad(fn(tq, tk, tv, causal),
                                         (tq, tk, tv), torch.from_numpy(do)))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)


def test_cpu_backward_runs_the_plain_kernels(monkeypatch):
    # the Function's CPU backward is K2 then K3 in their plain versions,
    # once each, never autograd's derivative of the plain forward; nothing
    # is counted as a kernel launch
    calls = []
    for name in ("_bwd_dq_reference", "_bwd_dkv_reference"):
        fn = getattr(P, name)

        def spy(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)
        monkeypatch.setattr(P, name, spy)
    q, k, v, do = _fwd_bwd_inputs(128, 32, seed=14)
    counts = [f.launches for f in (P.flash_attention, P.flash_attention_bwd_dq,
                                   P.flash_attention_bwd_dkv)]
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = P.flash_attention(tq, tk, tv)
    assert out.grad_fn.name().endswith("FlashAttentionBackward")
    torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert calls == ["_bwd_dq_reference", "_bwd_dkv_reference"]
    assert counts == [f.launches for f in (
        P.flash_attention, P.flash_attention_bwd_dq, P.flash_attention_bwd_dkv)]


def test_bwd_rejects_mismatched_shapes():
    q, k, v, do = _t(*_fwd_bwd_inputs(128, 32, seed=15))
    out, lse = P.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="do must have q's shape"):
        P.flash_attention_bwd(q, k, v, out, lse, do[:, :, :64])
    with pytest.raises(ValueError, match="seq lens"):
        P.flash_attention_bwd(q, k, v, out, lse, do, block_q=96)


def test_flash_bf16_grads_close_to_f32():
    # bf16 inputs: the plain backward computes in f32 and rounds dq, dk, dv
    # once, so each stays within a bf16 step (2^-8 relative) of the f32
    # gradients on the same (bf16-representable) inputs
    q, k, v, do = (x.to(torch.bfloat16)
                   for x in _t(*_fwd_bwd_inputs(128, 64, seed=16)))
    grads = []
    for dt in (torch.bfloat16, torch.float32):
        tq, tk, tv = (x.to(dt).requires_grad_() for x in (q, k, v))
        grads.append(torch.autograd.grad(P.flash_attention(tq, tk, tv),
                                         (tq, tk, tv), do.to(dt)))
    for g, w in zip(*grads):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=1e-2,
                                   rtol=1e-2)


# ------------------------------------- head dims off the kernels' widths


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [48, 80])
def test_padded_head_dim_matches_pallas_kernels(causal, D):
    # Dh 48 and 80 are zero-padded to 64 and 128 with 1/sqrt(Dh) kept: the
    # same K1, K2, K3 as the Pallas kernels at that Dh (interpret mode)
    q, k, v, do = _fwd_bwd_inputs(256, D, seed=17)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_out, j_lse = J._fwd(jq, jk, jv, causal, scale, 128, 128)
    out, lse = P.flash_attention_fwd(*_t(q, k, v), causal=causal)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)
    want = J._bwd(causal, scale, 128, 128, (jq, jk, jv, j_out, j_lse),
                  jnp.asarray(do))
    got = P.flash_attention_bwd(*_t(q, k, v), out, lse, *_t(do), causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD,
                                   err_msg=f"d{name}")
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    grads = torch.autograd.grad(P.flash_attention(tq, tk, tv, causal),
                                (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(grads, got):
        assert torch.equal(g, w)


def test_padded_head_dim_runs_the_kernels_at_their_width(monkeypatch):
    seen = []
    orig = P.flash_attention_reference

    def spy(q, *a, **kw):
        seen.append(q.shape[-1])
        return orig(q, *a, **kw)

    monkeypatch.setattr(P, "flash_attention_reference", spy)
    for D in (16, 48, 80, 128):
        q, k, v = _t(*_qkv(T=64, D=D))
        P.flash_attention_fwd(q, k, v)
    assert seen == [32, 64, 128, 128]


# --------------------------------------------------- the kv_len bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,T,n", [(False, 256, 250), (False, 256, 130),
                                        (True, 256, 200), (False, 128, 96)])
def test_kv_len_masks_the_padded_keys(dtype, causal, T, n):
    # keys past kv_len are zero padding (the ring's ragged chunk): K1 and K2
    # with the bound equal attention over the n real keys; K3 unbounded
    # gives the real keys' dK, dV (the padded query rows carry dO = 0)
    q, k, v, do = _fwd_bwd_inputs(T, 64, seed=18)
    q, k, v, do = (x.to(dtype) for x in _t(q, k, v, do))
    rows = slice(0, n)
    k[:, :, n:] = 0
    v[:, :, n:] = 0
    do[:, :, n:] = 0
    out, lse = P.flash_attention_fwd(q, k, v, causal, kv_len=n)
    dq, delta = P.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                         kv_len=n)
    dk, dv = P.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    # causal: the real query rows < n, from which causality hides keys >= n
    nq = n if causal else T
    qs = q[:, :, :nq].float().requires_grad_()
    ks, vs = (t[:, :, rows].float().requires_grad_() for t in (k, v))
    want = P.mha_reference(qs, ks, vs, causal=causal)
    tol = TOL if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out[:, :, :nq].float().numpy(),
                               want.detach().numpy(), **tol)
    wq, wk, wv = torch.autograd.grad(want, (qs, ks, vs),
                                     do[:, :, :nq].float())
    gtol = TOL_GRAD if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for g, w in ((dq[:, :, :nq], wq), (dk[:, :, rows], wk),
                 (dv[:, :, rows], wv)):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), **gtol)


def test_kv_len_is_checked():
    q, k, v = _t(*_qkv(T=128))
    for bad in (0, 129):
        with pytest.raises(ValueError, match="kv_len"):
            P.flash_attention_fwd(q, k, v, False, kv_len=bad)
