"""GPT-2 family in PyTorch: forward, loss value, KV-cache decode and chunked
prefill (counterpart of `ray_tpu/models/gpt2.py`).

Layouts are the JAX package's, so the two compare like with like:
- params are a nested dict of tensors with the same path-keyed names; the
  block params are stacked ``[n_layer, ...]`` and the layers run as a Python
  loop over that leading dimension;
- weights multiply as ``x @ W`` with ``W: [in, out]``;
- attention is ``[B, H, T, Dh]``; the KV cache is ``{"k","v"}:
  [n_layer, B, H, T, Dh]``.
Params are f32, compute is `cfg.dtype` (bf16 by default), LayerNorm, softmax
and the loss are f32. Only the forward value is ported: training (gradients,
remat, chunked CE) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.lm import cross_entropy, resolve_attn_impl, \
    split_lm_batch
from ray_tpu_torch.utils.platform import default_device

Params = Dict[str, Any]  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # GPT-2's 50257 padded to a 128 multiple
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 1024
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    # auto | dense | flash (the CUDA kernel K1); ring/ulysses raise
    attn_impl: str = "auto"
    # chunked fused cross-entropy belongs to the training slice; 0 = off
    ce_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def preset(cls, name: str, **overrides) -> "GPT2Config":
        presets = {
            "gpt2-125m": dict(n_layer=12, n_head=12, d_model=768, d_ff=3072),
            "gpt2-350m": dict(n_layer=24, n_head=16, d_model=1024, d_ff=4096),
            "gpt2-774m": dict(n_layer=36, n_head=20, d_model=1280, d_ff=5120),
            "gpt2-1.5b": dict(n_layer=48, n_head=25, d_model=1600, d_ff=6400),
            "gpt2-tiny": dict(n_layer=2, n_head=4, d_model=128, d_ff=512,
                              vocab_size=512, max_seq_len=128),
        }
        return cls(**{**presets[name], **overrides})


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: GPT2Config) -> Dict[str, tuple]:
    """Path-keyed leaf shapes, in the order `save_params` flattens them."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    block = {
        "attn/bo": (d,), "attn/bqkv": (3 * d,), "attn/wo": (d, d),
        "attn/wqkv": (d, 3 * d),
        "ln1/bias": (d,), "ln1/scale": (d,),
        "ln2/bias": (d,), "ln2/scale": (d,),
        "mlp/bi": (f,), "mlp/bo": (d,), "mlp/wi": (d, f), "mlp/wo": (f, d),
    }
    out = {f"blocks/{k}": (L,) + s for k, s in block.items()}
    out.update({"ln_f/bias": (d,), "ln_f/scale": (d,),
                "wpe": (cfg.max_seq_len, d), "wte": (cfg.vocab_size, d)})
    return out


def _nest(flat: Dict[str, Any]) -> Params:
    out: Params = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _flatten(params: Params, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k in sorted(params):
        v = params[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def init_params(generator: torch.Generator, cfg: GPT2Config,
                device=None) -> Params:
    """GPT-2 init: N(0, 0.02), residual projections scaled by
    1/sqrt(2*n_layer). Random numbers come from `generator` (a CPU
    generator); the params are then moved to `device`."""
    device = default_device(device)
    std = 0.02
    resid_std = std / math.sqrt(2 * cfg.n_layer)
    stds = {"blocks/attn/wqkv": std, "blocks/attn/wo": resid_std,
            "blocks/mlp/wi": std, "blocks/mlp/wo": resid_std,
            "wte": std, "wpe": std / 2}
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key in stds:
            t = torch.randn(shape, generator=generator) * stds[key]
        elif key.endswith("scale"):
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        flat[key] = t.to(device=device, dtype=cfg.param_dtype)
    return _nest(flat)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: Optional[GPT2Config]
                      = None, device=None) -> Params:
    """Path-keyed numpy leaves (the JAX tree flattened as `save_params`
    flattens it, ``blocks/...`` stacked ``[n_layer, ...]``) -> params. With
    `cfg`, every leaf's shape is checked and cast to ``cfg.param_dtype``."""
    device = default_device(device)
    if cfg is not None:
        want = param_shapes(cfg)
        if set(want) != set(flat):
            raise ValueError(f"checkpoint keys differ: missing "
                             f"{sorted(set(want) - set(flat))}, extra "
                             f"{sorted(set(flat) - set(want))}")
        for key, shape in want.items():
            if tuple(flat[key].shape) != shape:
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{flat[key].shape} != expected {shape}")
    dtype = cfg.param_dtype if cfg is not None else None
    return _nest({k: torch.from_numpy(np.array(v)).to(device=device,
                                                      dtype=dtype)
                  for k, v in flat.items()})


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """params -> path-keyed numpy leaves (the inverse of params_from_numpy)."""
    return {k: v.detach().cpu().numpy() for k, v in _flatten(params).items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, p, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _layer(blocks: Params, i: int) -> Params:
    """Layer i's params: views into the stacked block tensors."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def _qkv(x, p, cfg: GPT2Config):
    qkv = x @ p["wqkv"].to(cfg.dtype) + p["bqkv"].to(cfg.dtype)
    return qkv.split(cfg.d_model, dim=-1)


def _attention(x, p, cfg: GPT2Config):
    B, T, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2)
               for t in _qkv(x, p, cfg))
    impl = resolve_attn_impl(cfg.attn_impl, T, x.device)
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, True)
    elif impl == "dense":
        # f32 softmax for stability
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(Dh)
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=x.device).tril()
        scores = torch.where(causal, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = probs @ v
    else:
        raise ValueError(f"unknown attn_impl {impl!r}")
    out = out.transpose(1, 2).reshape(B, T, D)
    return out @ p["wo"].to(cfg.dtype) + p["bo"].to(cfg.dtype)


def _mlp(x, p, cfg: GPT2Config):
    h = x @ p["wi"].to(cfg.dtype) + p["bi"].to(cfg.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(cfg.dtype) + p["bo"].to(cfg.dtype)


def _block(x, bp, cfg: GPT2Config):
    x = x + _attention(_layer_norm(x, bp["ln1"]), bp["attn"], cfg)
    return x + _mlp(_layer_norm(x, bp["ln2"]), bp["mlp"], cfg)


def embed(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B,T] int -> embeddings [B,T,D] (compute dtype)."""
    T = tokens.shape[1]
    return (params["wte"][tokens] + params["wpe"][:T][None]).to(cfg.dtype)


def unembed(params: Params, x: torch.Tensor, cfg: GPT2Config):
    """final hidden [B,T,D] -> logits [B,T,vocab] (tied embeddings)."""
    x = _layer_norm(x, params["ln_f"])
    return x @ params["wte"].T.to(cfg.dtype)


def hidden_states(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B, T] int -> final hidden [B, T, D] (pre-unembed)."""
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layer):
        x = _block(x, _layer(params["blocks"], i), cfg)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B, T] int -> logits [B, T, vocab] (compute dtype)."""
    return unembed(params, hidden_states(params, tokens, cfg), cfg)


def loss_fn(params: Params, batch: dict, cfg: GPT2Config) -> torch.Tensor:
    """Next-token cross-entropy value. batch = {"tokens": [B,T+1]} or
    {"inputs": [B,T], "targets": [B,T]}."""
    if cfg.ce_chunk:
        raise NotImplementedError("ce_chunk comes with the training slice")
    inputs, targets = split_lm_batch(batch)
    return cross_entropy(forward(params, inputs, cfg), targets)


# ---------------------------------------------------------------------------
# KV-cache decode (serving path). Unlike the JAX functions, which return a
# new cache, these write the cache IN PLACE (and also return it): the cache
# is the largest serving buffer and a copy per step would double it.
# ---------------------------------------------------------------------------

def init_cache(cfg: GPT2Config, batch: int, max_len: Optional[int] = None,
               device=None):
    """Per-layer KV cache: {"k","v"}: [n_layer, B, H, T, Dh] (compute dtype)."""
    T = max_len or cfg.max_seq_len
    shape = (cfg.n_layer, batch, cfg.n_head, T, cfg.head_dim)
    device = default_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _cache_attention(q, ck, cv, pos, Dh, dtype):
    """q [B,H,C,Dh] against the whole cache [B,H,T,Dh]; lane c of slot b sees
    cache positions <= pos[b, c]."""
    T = ck.shape[2]
    scores = (q.float() @ ck.float().transpose(-1, -2)) / math.sqrt(Dh)
    t_idx = torch.arange(T, device=q.device)
    scores = torch.where(t_idx <= pos[:, None, :, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return probs @ cv


def decode_step(params: Params, cache, tokens: torch.Tensor,
                pos: torch.Tensor, active: torch.Tensor, cfg: GPT2Config):
    """One decode step for a continuous batch: tokens [B] int (current input
    token per slot), pos [B] int (its position), active [B] bool (slots whose
    cache advances). Returns (logits [B, vocab] f32, cache). Inactive slots'
    caches are untouched and their logits are garbage."""
    logits, cache = prefill_chunk(params, cache, tokens[:, None], pos,
                                  active.long(), active, cfg)
    return logits, cache


def prefill_chunk(params: Params, cache, tokens: torch.Tensor,
                  pos0: torch.Tensor, length: torch.Tensor,
                  active: torch.Tensor, cfg: GPT2Config):
    """Process up to C prompt tokens per slot in one step: tokens [B, C] int
    (left-aligned chunk per slot), pos0 [B] int (the chunk's first cache
    position), length [B] int (valid tokens, 0..C), active [B] bool.
    Returns (logits [B, vocab] f32 at each slot's last valid chunk token,
    cache). Inactive or zero-length slots' caches are untouched and their
    logits are garbage.

    Where JAX blends a clamped window (dynamic_update_slice clamps its start
    near the sequence end), this writes exactly the valid lanes of active
    slots at pos0 + lane, and drops lanes that would fall past the window:
    the same cache for every input the JAX function accepts."""
    B, C = tokens.shape
    H, Dh = cfg.n_head, cfg.head_dim
    T = cache["k"].shape[3]
    dev = tokens.device
    wte = params["wte"]
    lane = torch.arange(C, device=dev)
    pos = pos0[:, None] + lane[None, :]                          # [B, C]
    write = (lane[None, :] < length[:, None]) & active[:, None] & (pos < T) \
        & (pos >= 0)
    wb, wc = write.nonzero(as_tuple=True)                        # lanes kept
    wt = pos[wb, wc]
    x = wte[tokens] + params["wpe"][pos.clamp(0, cfg.max_seq_len - 1)]
    x = x.to(cfg.dtype)                                          # [B, C, D]
    for i in range(cfg.n_layer):
        bp = _layer(params["blocks"], i)
        h = _layer_norm(x, bp["ln1"])
        q, k, v = (t.reshape(B, C, H, Dh).transpose(1, 2)
                   for t in _qkv(h, bp["attn"], cfg))           # [B, H, C, Dh]
        ck, cv = cache["k"][i], cache["v"][i]                   # [B, H, T, Dh]
        # advanced indices around a slice: the indexed view is [n, H, Dh]
        ck[wb, :, wt] = k[wb, :, wc]
        cv[wb, :, wt] = v[wb, :, wc]
        # chunk lanes attend to everything written up to their own position
        # (causal within the chunk, full attention to the prefix)
        attn = _cache_attention(q, ck, cv, pos, Dh, cfg.dtype)
        attn = attn.transpose(1, 2).reshape(B, C, H * Dh)
        x = x + (attn @ bp["attn"]["wo"].to(cfg.dtype)
                 + bp["attn"]["bo"].to(cfg.dtype))
        x = x + _mlp(_layer_norm(x, bp["ln2"]), bp["mlp"], cfg)
    last = (length - 1).clamp(0, C - 1)
    x_last = _layer_norm(x[torch.arange(B, device=dev), last],
                         params["ln_f"])
    return (x_last @ wte.T.to(cfg.dtype)).float(), cache


def num_params(cfg: GPT2Config) -> int:
    d, f, L, V, S = (cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.vocab_size,
                     cfg.max_seq_len)
    per_block = (3 * d * d + 3 * d) + (d * d + d) + (2 * d * f + f + d) + 4 * d
    return V * d + S * d + L * per_block + 2 * d


# ---------------------------------------------------------------------------
# Checkpoint IO: the JAX package's format, params.npz (path-keyed leaves) +
# config.json (architecture), so either package loads what the other saved.
# ---------------------------------------------------------------------------

_CFG_FIELDS = ("vocab_size", "n_layer", "n_head", "d_model", "d_ff",
               "max_seq_len")


def save_params(path: str, params: Params, cfg: GPT2Config) -> str:
    """Write params + the architecture fields needed to rebuild them."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "params.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **params_to_numpy(params))
    os.replace(tmp, os.path.join(path, "params.npz"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in _CFG_FIELDS}, f)
    return path


def load_params(path: str, cfg: Optional[GPT2Config] = None, device=None
                ) -> Tuple[Params, GPT2Config]:
    """Load a save_params checkpoint; architecture comes from the sidecar
    (runtime knobs like dtype/attn_impl come from `cfg` when given)."""
    with open(os.path.join(path, "config.json")) as f:
        arch = json.load(f)
    cfg = dataclasses.replace(cfg or GPT2Config(), **arch)
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(flat, cfg, device), cfg
