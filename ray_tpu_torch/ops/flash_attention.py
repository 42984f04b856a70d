"""Flash attention forward: a hand-written sm_90a CUDA kernel and its plain
PyTorch versions.

Counterpart of `ray_tpu/ops/flash_attention.py`. The forward K1 (the Pallas
`_fwd_kernel`) is `csrc/flash_fwd.cu`; the backward kernels K2 and K3 belong to
the training slice and are not ported yet, so this module is forward only.

- `flash_attention(q, k, v, causal, scale, block_q, block_k)` keeps the JAX
  signature: q, k, v ``[B, H, T, Dh]`` -> ``[B, H, Tq, Dh]``.
- A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version `flash_attention_reference`; any other device raises.
- `flash_attention.launches` counts kernel launches.
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


def _launch(q, k, v, causal, scale):
    from ray_tpu_torch.ops import _kernels

    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention backward (kernels K2/K3) comes with the training "
            "slice; call under torch.no_grad() or use attn_impl='dense'")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    if max(strides) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's 32-bit strides")
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    out = torch.empty((B, H, Tq, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, Dh, *strides, int(causal),
        ctypes.c_float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


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
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, block_k)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Fused attention forward. q,k,v: [B, H, T, Dh] -> [B, H, T, Dh]."""
    return flash_attention_fwd(q, k, v, causal, scale, block_q, block_k)[0]


flash_attention.launches = 0
