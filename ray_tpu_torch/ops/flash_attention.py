"""Flash attention: hand-written sm_90a CUDA kernels, their plain PyTorch
versions, and the autograd glue between them.

Counterpart of `ray_tpu/ops/flash_attention.py`. Its three Pallas kernels are
each a CUDA kernel here: the forward K1 (`_fwd_kernel`) is
`csrc/flash_fwd.cu`; the backward K2 (`_bwd_dq_kernel`) and K3
(`_bwd_dkv_kernel`) are `csrc/flash_bwd.cu`. In bf16 all three run on the
tensor cores (mma.sync, f32 accumulators); in f32, on f32 FMAs.

- `flash_attention(q, k, v, causal, scale, block_q, block_k)` keeps the JAX
  signature: q, k, v ``[B, H, T, Dh]`` -> ``[B, H, Tq, Dh]``. It is a
  `torch.autograd.Function` standing in for the JAX `custom_vjp`: residuals
  ``(q, k, v, out, lse)``, forward K1, backward K2 then K3.
- A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version (`flash_attention_reference`, `flash_attention_bwd_reference`);
  any other device raises.
- Delta = rowsum(dO * O), which JAX computes outside its kernels, is a
  prologue of K2 here: K2 writes it to a ``[B, H, Tq]`` f32 buffer that K3
  reads, so the backward is two launches and no extra pass over dO and O.
- `flash_attention.launches`, `flash_attention_bwd_dq.launches` and
  `flash_attention_bwd_dkv.launches` count the launches of K1, K2 and K3.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense reference attention. q,k,v: [B, H, T, Dh]."""
    T, Dh = q.shape[-2:]
    Tk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        # offset aligns the causal diagonal when Tq != Tk (decode steps)
        qi = torch.arange(T, device=q.device)[:, None] + (Tk - T)
        ki = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None,
                              block_k: int = DEFAULT_BLOCK_K
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: blockwise online softmax over key blocks, f32 running
    max, normalizer and accumulator, causal diagonal at 0. Returns
    (out [B,H,Tq,Dh] in q's dtype, lse [B,H,Tq] f32).

    All query rows advance together. A key block past one row's causal
    frontier only masks that row (its weight is exp(-1e30 - m) = 0 and its
    correction exp(0) = 1), so each row's arithmetic is the kernel's."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    bk = min(block_k, Tk)
    qs = q.float() * scale
    m = torch.full((B, H, Tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, Dh), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    for k0 in range(0, Tk, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        s = qs @ kb.transpose(-1, -2)
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _check(q, k, v, causal, block_q, block_k):
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"expected q [B,H,Tq,Dh], k/v [B,H,Tk,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    Tq, Tk = q.shape[2], k.shape[2]
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if Tq % bq or Tk % bk:
        raise ValueError(f"seq lens ({Tq},{Tk}) must divide blocks "
                         f"({bq},{bk}); pad the sequence")
    if causal and Tq != Tk:
        # the JAX kernel puts the causal diagonal at 0 while mha_reference
        # puts it at Tk - Tq; the two disagree, so neither is guessed
        raise ValueError(f"causal flash attention needs Tq == Tk, got "
                         f"({Tq},{Tk})")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS}")


def _check_like(q, **ts):
    for name, t in ts.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")


def _bwd_tile(qf, kf, vf, dof, lse, delta, iq, jk, bq, bk, causal, scale):
    """One (q block, k block) tile of the backward, as both Pallas kernels
    compute it: P recomputed from lse, dS = P * (dP - Delta) * scale."""
    qs, ks = slice(iq * bq, (iq + 1) * bq), slice(jk * bk, (jk + 1) * bk)
    s = (qf[:, :, qs] * scale) @ kf[:, :, ks].transpose(-1, -2)
    if causal:
        q_pos = iq * bq + torch.arange(bq, device=qf.device)[:, None]
        k_pos = jk * bk + torch.arange(bk, device=qf.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    p = torch.exp(s - lse[:, :, qs])
    dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
    return p, p * (dp - delta[:, :, qs]) * scale


def _bwd_dq_reference(q, k, v, out, lse, do, causal, scale, block_q,
                      block_k) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2 (`_bwd_dq_kernel`) with its Delta prologue: per q block, walk
    the k blocks up to the causal frontier. Returns (dq in q's dtype,
    delta [B,H,Tq] f32)."""
    Tq, Tk = q.shape[2], k.shape[2]
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    lse = lse.float()[..., None]
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    for iq in range(Tq // bq):
        num_kb = Tk // bk
        if causal:
            num_kb = min(num_kb, ((iq + 1) * bq + bk - 1) // bk)
        for jk in range(num_kb):
            _, ds = _bwd_tile(qf, kf, vf, dof, lse, delta, iq, jk, bq, bk,
                              causal, scale)
            dq[:, :, iq * bq:(iq + 1) * bq] += ds @ kf[:, :, jk * bk:
                                                       (jk + 1) * bk]
    return dq.to(q.dtype), delta[..., 0]


def _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale, block_q,
                       block_k) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3 (`_bwd_dkv_kernel`): per k block, walk the q blocks from the
    causal start (jk * bk) // bq. Returns (dk, dv) in k's and v's dtypes."""
    Tq, Tk = q.shape[2], k.shape[2]
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    lse, delta = lse.float()[..., None], delta.float()[..., None]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for jk in range(Tk // bk):
        ks = slice(jk * bk, (jk + 1) * bk)
        for iq in range((jk * bk) // bq if causal else 0, Tq // bq):
            p, ds = _bwd_tile(qf, kf, vf, dof, lse, delta, iq, jk, bq, bk,
                              causal, scale)
            qs = slice(iq * bq, (iq + 1) * bq)
            dk[:, :, ks] += ds.transpose(-1, -2) @ qf[:, :, qs]
            dv[:, :, ks] += p.transpose(-1, -2) @ dof[:, :, qs]
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool = True,
                                  scale: Optional[float] = None,
                                  block_q: int = DEFAULT_BLOCK_Q,
                                  block_k: int = DEFAULT_BLOCK_K
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K2 + K3: the Pallas kernels' blockwise arithmetic in f32,
    with Delta = rowsum(dO * O) in f32. lse is ``[B, H, Tq]`` f32 as
    `flash_attention_fwd` returns it. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dq, delta = _bwd_dq_reference(q, k, v, out, lse, do, causal, scale,
                                  block_q, block_k)
    dk, dv = _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                                block_q, block_k)
    return dq, dk, dv


def _cp_async_ready(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte cp.async copies can read `t` in place:
    unit stride on the last dim, a base address and batch, head and time
    strides in bytes that are multiples of 16 (strides of a dim of size 1
    are never used)."""
    esz = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * esz % 16 == 0
                    for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _kernel_inputs(*ts):
    """Check the tensors a kernel reads and return them with their
    batch/head/time element strides.

    The rule: the kernels copy rows in 16-byte chunks (cp.async), so each
    tensor needs a unit stride on the last dim, a 16-byte-aligned base
    address and batch, head and time strides in bytes that are multiples of
    16. A tensor that breaks it is copied into a fresh contiguous one (the
    allocator aligns it, and with Dh in {32, 64, 128} its strides follow).
    The model's q/k/v views of the QKV product (time stride 3 * H * Dh) and
    autograd's transposed dO pass as they are."""
    dtype, device = ts[0].dtype, ts[0].device
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"flash kernels take float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if any(t.device != device for t in ts):
        raise ValueError("flash kernel inputs must be on one device")
    ts = [t if _cp_async_ready(t)
          else t.clone(memory_format=torch.contiguous_format) for t in ts]
    strides = [s for t in ts for s in t.stride()[:3]]
    if max(strides) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's 32-bit strides")
    return ts, strides


def _stats(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """lse or Delta as the kernels read it: contiguous [B, H, Tq] f32 on
    q's device."""
    if tuple(t.shape) != tuple(q.shape[:3]) or t.device != q.device:
        raise ValueError(f"expected a row statistic of shape "
                         f"{tuple(q.shape[:3])} on {q.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch(q, k, v, causal, scale):
    from ray_tpu_torch.ops import _kernels

    (q, k, v), strides = _kernel_inputs(q, k, v)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    out = torch.empty((B, H, Tq, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib.rt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, Dh, *strides, int(causal),
        ctypes.c_float(scale), _DTYPES[q.dtype], stream), "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def _launch_bwd_dq(q, k, v, out, lse, do, causal, scale):
    from ray_tpu_torch.ops import _kernels

    (q, k, v, out, do), strides = _kernel_inputs(q, k, v, out, do)
    B, H, Tq, Dh = q.shape
    lse = _stats(lse, q)
    dq = torch.empty((B, H, Tq, Dh), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib.rt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        B, H, Tq, k.shape[2], Dh, (ctypes.c_int * len(strides))(*strides),
        int(causal), ctypes.c_float(scale), _DTYPES[q.dtype], stream),
        "flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    from ray_tpu_torch.ops import _kernels

    (q, k, v, do), strides = _kernel_inputs(q, k, v, do)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    lse, delta = _stats(lse, q), _stats(delta, q)
    dk, dv = (torch.empty((B, H, Tk, Dh), dtype=q.dtype, device=q.device)
              for _ in range(2))
    lib = _kernels.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib.rt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Tq, Tk, Dh, (ctypes.c_int * len(strides))(*strides),
        int(causal), ctypes.c_float(scale), _DTYPES[q.dtype], stream),
        "flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _route(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (out [B,H,Tq,Dh], lse [B,H,Tq] f32). block_q/block_k set the
    divisibility contract of the JAX kernel; the CUDA kernel picks its own
    tiles."""
    _check(q, k, v, causal, block_q, block_k)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "cuda":
        return _launch(q, k, v, causal, scale)
    return flash_attention_reference(q, k, v, causal, scale, block_k)


def flash_attention_bwd_dq(q, k, v, out, lse, do, causal: bool = True,
                           scale: Optional[float] = None,
                           block_q: int = DEFAULT_BLOCK_Q,
                           block_k: int = DEFAULT_BLOCK_K
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (dq in q's dtype, delta [B,H,Tq] f32), delta = rowsum(dO * O)."""
    _check(q, k, v, causal, block_q, block_k)
    _check_like(q, out=out, do=do)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "cuda":
        return _launch_bwd_dq(q, k, v, out, lse, do, causal, scale)
    return _bwd_dq_reference(q, k, v, out, lse, do, causal, scale, block_q,
                             block_k)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None,
                            block_q: int = DEFAULT_BLOCK_Q,
                            block_k: int = DEFAULT_BLOCK_K
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) in k's and v's dtypes, from K2's delta."""
    _check(q, k, v, causal, block_q, block_k)
    _check_like(q, do=do)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "cuda":
        return _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                              block_q, block_k)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                        scale: Optional[float] = None,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward of `flash_attention`: K2 then K3. Returns (dq, dk, dv)."""
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal, scale,
                                       block_q, block_k)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     block_q, block_k)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The JAX `custom_vjp` of `flash_attention`: residuals (q, k, v, out,
    lse); forward K1, backward K2 then K3 (their plain versions on the CPU,
    so the CPU backward is the kernels' arithmetic, not autograd's
    derivative of the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        out, lse = flash_attention_fwd(q, k, v, causal, scale, block_q,
                                       block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Fused attention with gradients. q,k,v: [B, H, T, Dh] -> [B, H, T, Dh]."""
    return FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
