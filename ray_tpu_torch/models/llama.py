"""LLaMA family in PyTorch: RMSNorm, rotary embeddings, grouped-query
attention, SwiGLU; forward, loss and its gradients (with remat), KV-cache
decode (counterpart of `ray_tpu/models/llama.py`).

Layouts are the JAX package's, as in `models.gpt2`: params are a nested dict
of tensors with the JAX tree's path-keyed names, the block params stacked
``[n_layer, ...]`` and run as a Python loop over views of that dimension;
weights multiply as ``x @ W``; the KV cache is ``{"k","v"}: [n_layer, B,
n_kv_head, T, Dh]``, so it holds the KV heads only. Params are f32, compute
is `cfg.dtype` (bf16 by default), RMSNorm, RoPE, softmax and the loss are
f32.

Grouped-query attention gives query head ``h`` the K/V head ``h // q_per_kv``
(JAX's broadcast of ``[B,T,KV,1,Dh]`` to ``[B,T,KV,G,Dh]``). K and V are
expanded to every query head before attention, a copy, so that the flash
kernels (K1-K3 of `ops.flash_attention`) take them as ``[B, H, T, Dh]``
unchanged; autograd sums dK and dV over each group, as the transpose of
JAX's broadcast does. On a mesh the KV heads stay replicated over tp
(the rule for "kv"), so each rank expands them and keeps its query heads'
share (`constrain`, as in `models.gpt2`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt2 as _gpt2
from ray_tpu_torch.models.lm import cross_entropy, matmul, \
    resolve_attn_impl, split_lm_batch
from ray_tpu_torch.parallel.mesh import constrain
from ray_tpu_torch.utils.platform import default_device

Params = Dict[str, Any]  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32              # < n_head => grouped-query attention
    d_model: int = 4096
    d_ff: int = 11008                # SwiGLU hidden size
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True               # torch.utils.checkpoint around each block
    attn_impl: str = "auto"          # auto | dense | flash | ring | ulysses

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    @classmethod
    def preset(cls, name: str, **overrides) -> "LlamaConfig":
        presets = {
            "llama2-7b": dict(n_layer=32, n_head=32, n_kv_head=32,
                              d_model=4096, d_ff=11008, vocab_size=32000),
            "llama2-13b": dict(n_layer=40, n_head=40, n_kv_head=40,
                               d_model=5120, d_ff=13824, vocab_size=32000),
            "llama3-8b": dict(n_layer=32, n_head=32, n_kv_head=8,
                              d_model=4096, d_ff=14336, vocab_size=128256,
                              rope_theta=500000.0, max_seq_len=8192),
            "tinyllama-1.1b": dict(n_layer=22, n_head=32, n_kv_head=4,
                                   d_model=2048, d_ff=5632, vocab_size=32000),
            "llama-tiny": dict(n_layer=2, n_head=4, n_kv_head=2, d_model=128,
                               d_ff=352, vocab_size=512, max_seq_len=128),
        }
        return cls(**{**presets[name], **overrides})


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _attn_shapes(cfg) -> Dict[str, tuple]:
    """The attention and norm leaves of one block (Llama and MoE share
    them)."""
    D = cfg.d_model
    kv = cfg.n_kv_head * cfg.head_dim
    return {"attn/wk": (D, kv), "attn/wo": (D, D), "attn/wq": (D, D),
            "attn/wv": (D, kv), "attn_norm/scale": (D,),
            "mlp_norm/scale": (D,)}


def _model_shapes(cfg, block: Dict[str, tuple]) -> Dict[str, tuple]:
    """Path-keyed leaf shapes of a model with these per-block leaves."""
    D = cfg.d_model
    out = {f"blocks/{k}": (cfg.n_layer,) + s for k, s in block.items()}
    out.update({"final_norm/scale": (D,), "wte": (cfg.vocab_size, D)})
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, cfg.vocab_size)
    return dict(sorted(out.items()))


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Path-keyed leaf shapes, in sorted-key order (the JAX tree's);
    ``lm_head`` only when the embeddings are untied."""
    D, Fd = cfg.d_model, cfg.d_ff
    return _model_shapes(cfg, {**_attn_shapes(cfg), "mlp/wd": (Fd, D),
                               "mlp/wg": (D, Fd), "mlp/wu": (D, Fd)})


def _init(generator: torch.Generator, cfg, shapes: Dict[str, tuple],
          resid: tuple, device) -> Params:
    """N(0, 0.02) for every weight, N(0, 0.02/sqrt(2*n_layer)) for the
    leaves named in `resid`, ones for the norm scales. The numbers are drawn
    on the generator's own device, leaf by leaf in `shapes` order, then
    moved to `device`: a CUDA generator fills a model too large for the
    host's memory directly on the card."""
    device = default_device(device)
    # on the meta device (shapes only) nothing is drawn
    src = device if device.type == "meta" else generator.device
    std = 0.02
    resid_std = std / math.sqrt(2 * cfg.n_layer)
    flat = {}
    for key, shape in shapes.items():
        if key.endswith("scale"):
            t = torch.ones(shape, device=src)
        else:
            t = torch.randn(shape, generator=generator, device=src)
            t.mul_(resid_std if key in resid else std)
        flat[key] = t.to(device=device, dtype=cfg.param_dtype)
    return _gpt2._nest(flat)


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device=None) -> Params:
    """The JAX package's init (std 0.02, the output projections wo and wd
    scaled by 1/sqrt(2*n_layer)), drawn from `generator` on its device."""
    return _init(generator, cfg, param_shapes(cfg),
                 ("blocks/attn/wo", "blocks/mlp/wd"), device)


def params_from_numpy(flat: Dict[str, np.ndarray],
                      cfg: Optional[LlamaConfig] = None, device=None
                      ) -> Params:
    """Path-keyed numpy leaves (the JAX tree flattened, ``blocks/...``
    stacked ``[n_layer, ...]``) -> params; with `cfg`, shapes are checked
    and leaves cast to ``cfg.param_dtype``."""
    return _gpt2._params_from_flat(
        flat, param_shapes(cfg) if cfg is not None else None, cfg, device)


# params -> path-keyed numpy leaves (the inverse of params_from_numpy)
params_to_numpy = _gpt2.params_to_numpy


def _attn_axes() -> Params:
    """The attention and norm leaves' logical axes (Llama and MoE share
    them)."""
    return {
        "attn_norm": {"scale": ("embed",)},
        "attn": {
            "wq": ("embed", "heads"),
            "wk": ("embed", "kv"),
            "wv": ("embed", "kv"),
            "wo": ("heads", "embed"),
        },
        "mlp_norm": {"scale": ("embed",)},
    }


def _model_axes(cfg, block: Params) -> Params:
    axes = {
        "wte": ("vocab", "embed"),
        "blocks": _gpt2._stack_axes(block),
        "final_norm": {"scale": ("embed",)},
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Logical axis names per param leaf (the JAX model's)."""
    return _model_axes(cfg, {**_attn_axes(), "mlp": {
        "wg": ("embed", "mlp"),
        "wu": ("embed", "mlp"),
        "wd": ("mlp", "embed"),
    }})


def param_specs(cfg: LlamaConfig, rules=None) -> Params:
    return _gpt2._specs(param_logical_axes(cfg), rules)


# ---------------------------------------------------------------------------
# Building blocks (reused by ray_tpu_torch.models.moe)
# ---------------------------------------------------------------------------

def rms_norm(x, p, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., T] int -> (cos, sin) each [..., T, head_dim/2] f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., T, n_head, head_dim]; cos/sin broadcastable [..., T, 1, hd/2].
    The half-split rotation (first half against second half), in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def expand_kv(t: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, T, KV, Dh] -> [B, T, KV * q_per_kv, Dh]: query head h reads KV
    head h // q_per_kv (expand, then a copy by reshape). Its backward sums
    each group."""
    if q_per_kv == 1:
        return t
    B, T, KV, Dh = t.shape
    return t.unsqueeze(3).expand(B, T, KV, q_per_kv, Dh).reshape(
        B, T, KV * q_per_kv, Dh)


def dense_attention(q, k, v, dtype):
    """Causal attention, q,k,v [B, H, T, Dh]: f32 scores (products of the
    compute-dtype values, summed in f32), a -1e30 mask, softmax in f32,
    probabilities cast to the compute dtype before their product with v."""
    T, Dh = q.shape[-2:]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(Dh)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return probs @ v


def attention(x, p, cfg):
    """Causal GQA with RoPE. x [B,T,D]; p has wq/wk/wv/wo."""
    B, T, D = x.shape
    H, KV, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = matmul(x, p["wq"].to(cfg.dtype)).reshape(B, T, H, Dh)
    k = matmul(x, p["wk"].to(cfg.dtype)).reshape(B, T, KV, Dh)
    v = matmul(x, p["wv"].to(cfg.dtype)).reshape(B, T, KV, Dh)

    cos, sin = rope_freqs(torch.arange(T, device=x.device), Dh,
                          cfg.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = expand_kv(k, cfg.q_per_kv), expand_kv(v, cfg.q_per_kv)

    q, k, v = (constrain(t.transpose(1, 2), "batch", "heads", "seq", None)
               for t in (q, k, v))                        # [B, H, T, Dh]
    impl = resolve_attn_impl(cfg.attn_impl, T, x.device)
    if impl == "dense":
        out = _gpt2._dense(q, k, v, cfg.dtype, dense_attention)
    else:
        out = _gpt2.sharded_attention(impl, q, k, v)
    out = out.transpose(1, 2).reshape(B, T, D)
    return matmul(out, p["wo"].to(cfg.dtype))


def swiglu(x, p, cfg):
    g = matmul(x, p["wg"].to(cfg.dtype))
    u = matmul(x, p["wu"].to(cfg.dtype))
    h = constrain(F.silu(g) * u, "batch", "seq", "mlp")
    return matmul(h, p["wd"].to(cfg.dtype))


def _block(x, bp, cfg: LlamaConfig):
    x = x + attention(rms_norm(x, bp["attn_norm"], cfg.norm_eps), bp["attn"],
                      cfg)
    x = constrain(x, "batch", "seq", "embed")
    x = x + swiglu(rms_norm(x, bp["mlp_norm"], cfg.norm_eps), bp["mlp"],
                   cfg)
    return constrain(x, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens [B,T] int -> embeddings [B,T,D] (compute dtype). On a mesh the
    table is gathered whole first, as `gpt2.embed` does (the JAX model
    leaves the lookup to GSPMD); DTensor's masked lookup of a vocab shard
    fails on batch-sharded tokens."""
    wte = constrain(params["wte"], None, None)
    return constrain(F.embedding(tokens, wte).to(cfg.dtype), "batch", "seq",
                     "embed")


def unembed(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """final hidden [B,T,D] -> logits [B,T,vocab] (compute dtype)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["wte"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(matmul(x, head.to(cfg.dtype)), "batch", "seq",
                     "vocab")


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
            ) -> torch.Tensor:
    """tokens [B,T] int -> logits [B,T,vocab] (compute dtype)."""
    x = embed(params, tokens, cfg)
    block_fn = _gpt2._remat(functools.partial(_block, cfg=cfg),
                            "full" if cfg.remat else None)
    for bp in _gpt2._layers(params["blocks"]):
        x = block_fn(x, bp)
    return unembed(params, x, cfg)


def loss_fn(params: Params, batch: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy. batch = {"tokens": [B,T+1]} or
    {"inputs": [B,T], "targets": [B,T]}."""
    inputs, targets = split_lm_batch(batch)
    return cross_entropy(forward(params, inputs, cfg), targets)


# ---------------------------------------------------------------------------
# KV-cache decode (serving path). As in models.gpt2, the cache is written IN
# PLACE and also returned, where the JAX function returns a new cache.
# ---------------------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               device=None):
    """{"k","v"}: [n_layer, B, n_kv_head, T, Dh] (compute dtype)."""
    T = max_len or cfg.max_seq_len
    shape = (cfg.n_layer, batch, cfg.n_kv_head, T, cfg.head_dim)
    device = default_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params: Params, cache, tokens: torch.Tensor,
                pos: torch.Tensor, active: torch.Tensor, cfg: LlamaConfig):
    """One continuous-batch decode step: tokens [B] int, pos [B] int,
    active [B] bool -> (logits [B, vocab] f32, cache). Active rows write
    their k/v at pos (clamped into the cache, as JAX's dynamic_update_slice
    clamps); inactive rows' caches are untouched and their logits are
    garbage. Attention is dense over the cache: grouped scores, q
    [B,KV,G,Dh] against [B,KV,T,Dh], in f32."""
    B = tokens.shape[0]
    H, KV, Dh, G = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.q_per_kv
    T = cache["k"].shape[3]
    x = params["wte"][tokens].to(cfg.dtype)                   # [B, D]
    cos, sin = rope_freqs(pos, Dh, cfg.rope_theta)            # [B, Dh/2]
    cos, sin = cos[:, None, :], sin[:, None, :]
    rows = active.nonzero(as_tuple=True)[0]
    at = pos.clamp(0, T - 1)[rows]
    seen = torch.arange(T, device=pos.device) <= pos[:, None]  # [B, T]
    for i, bp in enumerate(_gpt2._layers(params["blocks"])):
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        q = (h @ bp["attn"]["wq"].to(cfg.dtype)).reshape(B, H, Dh)
        k = (h @ bp["attn"]["wk"].to(cfg.dtype)).reshape(B, KV, Dh)
        v = (h @ bp["attn"]["wv"].to(cfg.dtype)).reshape(B, KV, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ck, cv = cache["k"][i], cache["v"][i]                 # [B, KV, T, Dh]
        # advanced indices around a slice: the indexed view is [n, KV, Dh]
        ck[rows, :, at] = k[rows]
        cv[rows, :, at] = v[rows]
        qg = q.reshape(B, KV, G, Dh)
        scores = (qg.float() @ ck.float().transpose(-1, -2)) / math.sqrt(Dh)
        scores = torch.where(seen[:, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        attn = (probs @ cv).reshape(B, H * Dh)
        x = x + attn @ bp["attn"]["wo"].to(cfg.dtype)
        x = x + swiglu(rms_norm(x, bp["mlp_norm"], cfg.norm_eps), bp["mlp"],
                       cfg)
    return unembed(params, x, cfg).float(), cache


def num_params(cfg: LlamaConfig) -> int:
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.vocab_size
    kv_dim = cfg.n_kv_head * cfg.head_dim
    per_block = D * D * 2 + D * kv_dim * 2 + 3 * D * Fd + 2 * D
    total = V * D + L * per_block + D
    if not cfg.tie_embeddings:
        total += D * V
    return total
