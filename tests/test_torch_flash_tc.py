"""The tensor-core redesign of K1, K2 and K3, checked on the CPU.

- The wrappers' 16-byte rule for the kernels' cp.async copies: which inputs
  are read in place and which are copied.
- The redesign's extra rounding: bf16 K1 rounds P to bf16 before its
  product with V, bf16 K2 rounds dS to bf16 before its product with K, and
  bf16 K3 rounds P^T and dS^T to bf16 before their products with dO and Q,
  each with f32 accumulation. Plain emulations of those three bodies, on
  bf16-valued inputs at gpt2-tiny sizes, stay within chip_smoke.py's
  unchanged bf16 tolerances of the plain versions in f32: the tolerances
  the card's kernels are held to.
- The kernel library's name follows the shared headers as well as the
  source.

Needs neither a card nor JAX.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import TOL_GRAD_PLAIN, TOL_LSE, TOL_PLAIN
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as P

BF16 = torch.bfloat16


# ------------------------------------------------------ the 16-byte rule

def _model_views(B=2, T=128, H=4, D=64, dtype=BF16):
    """q, k, v split from a [B, T, 3D] tensor and dO the transposed view of
    a [B, T, D] one, as gpt2._attention and autograd hand them over."""
    qkv = torch.randn((B, T, 3 * H * D)).to(dtype)
    do = torch.randn((B, T, H * D)).to(dtype)
    return [t.reshape(B, T, H, D).transpose(1, 2)
            for t in (*qkv.split(H * D, dim=-1), do)]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_model_layout_is_read_in_place(dtype, D):
    views = _model_views(D=D, dtype=dtype)
    got, strides = P._kernel_inputs(*views)
    assert [t.data_ptr() for t in got] == [t.data_ptr() for t in views]
    assert strides == [s for t in views for s in t.stride()[:3]]


def test_offset_view_is_copied_aligned():
    B, H, T, D = 2, 4, 128, 64
    flat = torch.randn(1 + B * H * T * D).to(BF16)
    off = flat[1:].view(B, H, T, D)  # contiguous, base 2 bytes off
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    (got,), strides = P._kernel_inputs(off)
    assert got.data_ptr() != off.data_ptr() and got.data_ptr() % 16 == 0
    assert got.is_contiguous() and torch.equal(got, off)
    assert strides == list(got.stride()[:3])


def test_unaligned_time_stride_is_copied():
    # rows of 65 bf16 (130 bytes): a time stride cp.async cannot step
    B, H, T, D = 1, 2, 64, 64
    base = torch.randn((B, H, T, D + 1)).to(BF16)
    view = base[..., :D]
    assert view.stride(-1) == 1 and view.data_ptr() % 16 == 0
    (got,), _ = P._kernel_inputs(view)
    assert got.is_contiguous() and torch.equal(got, view)
    # a size-1 dim's stride is never used, so it does not force a copy
    one = torch.randn((1, H, T, D)).to(BF16).as_strided(
        (1, H, T, D), (3, T * D, D, 1))
    (same,), _ = P._kernel_inputs(one)
    assert same.data_ptr() == one.data_ptr()


# ------------------------------------------------- the extra rounding

def _bf16_inputs(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32)).to(BF16)
            for _ in range(4)]


def _causal_keep(T, q0, nq, k0, nk):
    q_pos = torch.arange(q0, q0 + nq)[:, None]
    return q_pos >= torch.arange(k0, k0 + nk)[None, :]


def k1_tensor_core_emulation(q, k, v, causal, scale, bk=64):
    """bf16 K1 as the tensor-core body computes it: f32 scores of bf16
    inputs, `scale` applied to the f32 scores, the online softmax over
    64-key tiles in f32 with l summing the f32 P, P rounded to bf16 before
    P V (f32 accumulation), O rounded once to bf16."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    B, H, T, D = q.shape
    m = torch.full((B, H, T, 1), P.NEG_INF)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    for k0 in range(0, k.shape[2], bk):
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(_causal_keep(T, 0, T, k0, s.shape[-1]), s,
                            P.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(BF16).float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(BF16)


def k2_tensor_core_emulation(q, k, v, out, lse, do, causal, scale, bk=64):
    """bf16 K2 as the tensor-core body computes it: Delta = rowsum(dO * O)
    in f32 from the bf16 values; per 64-key tile, S = Q K^T and dP = dO V^T
    in f32, P = exp(S scale - lse) and dS = P (dP - Delta) in f32, dS
    rounded to bf16 before dQ += dS K (f32 accumulation); dQ times scale
    once, rounded once to bf16. Returns (dQ, Delta)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    T = q.shape[2]
    delta = (dof * out.float()).sum(-1)
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[2], bk):
        ks = slice(k0, k0 + bk)
        p = torch.exp(qf @ kf[:, :, ks].transpose(-1, -2) * scale
                      - lse[..., None])
        if causal:
            p = torch.where(_causal_keep(T, 0, T, k0, p.shape[-1]), p, 0.0)
        dp = dof @ vf[:, :, ks].transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        dq += ds.to(BF16).float() @ kf[:, :, ks]
    return (dq * scale).to(BF16), delta


def k3_tensor_core_emulation(q, k, v, do, lse, delta, causal, scale,
                             bq=64):
    """bf16 K3 as the tensor-core body computes it: per q tile, S^T = K Q^T
    and dP^T = V dO^T in f32, P^T = exp(S^T scale - lse) and dS^T = P^T
    (dP^T - Delta) in f32, both rounded to bf16 before dV += P^T dO and
    dK += dS^T Q (f32 accumulation); dK times scale once; both rounded once
    to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    T = q.shape[2]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, T, bq):
        qs = slice(q0, q0 + bq)
        pt = torch.exp(kf @ qf[:, :, qs].transpose(-1, -2) * scale
                       - lse[:, :, None, qs])
        if causal:
            keep = _causal_keep(T, q0, pt.shape[-1], 0, T).transpose(0, 1)
            pt = torch.where(keep, pt, 0.0)
        dpt = vf @ dof[:, :, qs].transpose(-1, -2)
        dst = pt * (dpt - delta[:, :, None, qs])
        dv += pt.to(BF16).float() @ dof[:, :, qs]
        dk += dst.to(BF16).float() @ qf[:, :, qs]
    return (dk * scale).to(BF16), dv.to(BF16)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
def test_k1_bf16_rounding_of_p_fits_the_tolerance(D, causal):
    q, k, v, _ = _bf16_inputs(2, 4, 128, D, seed=D + causal)
    scale = 1.0 / math.sqrt(D)
    got = k1_tensor_core_emulation(q, k, v, causal, scale)
    want, _ = P.flash_attention_reference(q.float(), k.float(), v.float(),
                                          causal, scale)
    _assert_close(got, want, TOL_PLAIN[BF16])
    assert not torch.equal(got.float(), want)  # the rounding is modelled


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
def test_k3_bf16_rounding_of_p_and_ds_fits_the_tolerance(D, causal):
    q, k, v, do = _bf16_inputs(2, 4, 128, D, seed=10 + D + causal)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    out, lse = P.flash_attention_reference(qf, kf, vf, causal, scale)
    _, delta = P._bwd_dq_reference(qf, kf, vf, out, lse, dof, causal, scale,
                                   128, 128)
    got = k3_tensor_core_emulation(q, k, v, do, lse, delta, causal, scale)
    want = P._bwd_dkv_reference(qf, kf, vf, dof, lse, delta, causal, scale,
                                128, 128)
    for g, w in zip(got, want):
        _assert_close(g, w, TOL_GRAD_PLAIN[BF16])
        assert not torch.equal(g.float(), w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
def test_k2_bf16_rounding_of_ds_fits_the_tolerance(D, causal):
    q, k, v, do = _bf16_inputs(2, 4, 128, D, seed=20 + D + causal)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    out, lse = P.flash_attention_reference(qf, kf, vf, causal, scale)
    out = out.to(BF16)  # the kernel reads O as K1 wrote it, in bf16
    got, delta = k2_tensor_core_emulation(q, k, v, out, lse, do, causal,
                                          scale)
    want, want_delta = P._bwd_dq_reference(qf, kf, vf, out, lse, dof,
                                           causal, scale, 128, 128)
    _assert_close(got, want, TOL_GRAD_PLAIN[BF16])
    _assert_close(delta, want_delta, TOL_LSE)
    # the rounding of dS is modelled: it moves some dQ off the plain
    # version's own bf16 rounding
    assert not torch.equal(got, want.to(BF16))


# ------------------------------------------ the library's name and headers

def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    for name in ("flash_fwd.cu", "tc_common.cuh", "other.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_kernels, "CSRC", str(tmp_path))
    first = _kernels._lib_path("flash_fwd")
    assert first == _kernels._lib_path("flash_fwd")
    (tmp_path / "tc_common.cuh").write_text("// edited\n")
    second = _kernels._lib_path("flash_fwd")
    assert second != first
    (tmp_path / "flash_fwd.cu").write_text("// edited\n")
    assert _kernels._lib_path("flash_fwd") not in (first, second)


BUILD_PROBE = r"""
import sys
from ray_tpu_torch.ops import _kernels
_kernels.CSRC, _kernels.BUILD_DIR = sys.argv[1], sys.argv[2]
_kernels._nvcc = lambda: sys.argv[3]
_kernels.build_all(["flash_fwd"])
"""


def test_two_processes_build_a_library_once(tmp_path):
    """Two processes that find no library at the same moment (two Tune
    trials on one card) run one build between them: the second waits on
    the first's lock, then finds its library and its log."""
    import os
    import subprocess
    import sys

    src, build = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "flash_fwd.cu").write_text("// k1\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    # a stand-in compiler: counts its runs, takes a second, writes -o
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        "sleep 1\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi; shift\n"
        "done\n"
        "echo 'ptxas info: 0 bytes spill'\n")
    nvcc.chmod(0o755)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_PROBE, str(src),
                               str(build), str(nvcc)], cwd=root)
             for _ in range(2)]
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    assert calls.read_text().count("run") == 1
    libs = [f for f in os.listdir(build) if f.endswith(".so")]
    assert len(libs) == 1
    assert "spill" in (build / f"{libs[0]}.log").read_text()
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
