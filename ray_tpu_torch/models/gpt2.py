"""GPT-2 family in PyTorch: forward, loss and its gradients (with remat and
chunked cross-entropy), KV-cache decode and chunked prefill (counterpart of
`ray_tpu/models/gpt2.py`).

Layouts are the JAX package's, so the two compare like with like:
- params are a nested dict of tensors with the same path-keyed names; the
  block params are stacked ``[n_layer, ...]`` and the layers run as a Python
  loop over views of that leading dimension (`jax.lax.scan` there);
- weights multiply as ``x @ W`` with ``W: [in, out]``;
- attention is ``[B, H, T, Dh]``; the KV cache is ``{"k","v"}:
  [n_layer, B, H, T, Dh]``.
Params are f32, compute is `cfg.dtype` (bf16 by default), LayerNorm, softmax
and the loss are f32. Gradients are autograd's; `jax.checkpoint` around each
block becomes `torch.utils.checkpoint` (see `hidden_states`).

Sharding is the JAX package's: `param_logical_axes` names each leaf's
logical axes, `param_specs` resolves them under the active rules, and
`constrain` marks the activations at the same points as the JAX model. On
a mesh (`parallel.mesh.use_mesh`, params as DTensors) the same code runs
sharded; without one `constrain` does nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint, \
    create_selective_checkpoint_contexts

from ray_tpu_torch.models.lm import cross_entropy, matmul, \
    resolve_attn_impl, split_lm_batch, token_nll
from ray_tpu_torch.ops.flash_attention import on_local_shards
from ray_tpu_torch.parallel.mesh import constrain, logical_to_spec, \
    with_current_mesh
from ray_tpu_torch.utils.platform import default_device
from ray_tpu_torch.utils.tree import nest as _nest

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
    # recompute each block in the backward pass instead of keeping its
    # activations (jax.checkpoint around the block in the JAX package)
    remat: bool = True
    # "full" recomputes everything; "dots" keeps the outputs of the x @ W
    # products (JAX's dots_with_no_batch_dims_saveable); "dots_all" also
    # keeps the batched attention products (dots_saveable)
    remat_policy: str = "full"
    # auto | dense | flash (the CUDA kernels K1-K3) | ring | ulysses (the
    # sequence over the mesh's sp axis, ops.ring_attention)
    attn_impl: str = "auto"
    # chunked fused cross-entropy: unembed + CE per ce_chunk-token slice,
    # each slice recomputed in the backward pass, so the [B, T, V] logits
    # never exist at once. 0 = off (plain unembed + CE)
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


def _stack_axes(block: Params) -> Params:
    """Prefix every block leaf's axes with the stacked layer dim's logical
    axis "layers" (unsharded by default)."""
    return {k: _stack_axes(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in block.items()}


def _specs(axes: Params, rules) -> Params:
    """A logical-axes tree resolved to PartitionSpecs under `rules` (the
    active ones when None)."""
    return {k: _specs(v, rules) if isinstance(v, dict)
            else logical_to_spec(*v, rules=rules) for k, v in axes.items()}


def param_logical_axes(cfg: GPT2Config) -> Params:
    """Logical axis names per param leaf (same tree structure as
    init_params). `embed` is the ZeRO/fsdp-sharded hidden axis, `mlp`- and
    `heads`-shaped output dims shard over tp, `vocab` over tp (tied
    embedding: the logits matmul is tp-sharded)."""
    del cfg
    block = {
        "ln1": {"scale": ("embed",), "bias": ("embed",)},
        "attn": {
            "wqkv": ("embed", "heads"),   # 3*d_model output dim, col-parallel
            "bqkv": ("heads",),
            "wo": ("heads", "embed"),     # row-parallel back to hidden
            "bo": ("embed",),
        },
        "ln2": {"scale": ("embed",), "bias": ("embed",)},
        "mlp": {
            "wi": ("embed", "mlp"),
            "bi": ("mlp",),
            "wo": ("mlp", "embed"),
            "bo": ("embed",),
        },
    }
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": _stack_axes(block),
        "ln_f": {"scale": ("embed",), "bias": ("embed",)},
    }


def param_specs(cfg: GPT2Config, rules=None) -> Params:
    """PartitionSpec tree for the params under the active (or given)
    rules."""
    return _specs(param_logical_axes(cfg), rules)


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
    return _params_from_flat(flat, param_shapes(cfg) if cfg is not None
                             else None, cfg, device)


def _params_from_flat(flat: Dict[str, np.ndarray],
                      want: Optional[Dict[str, tuple]], cfg, device
                      ) -> Params:
    """params_from_numpy of any model family: `want` is its param_shapes
    (None: take the leaves as they are)."""
    device = default_device(device)
    if want is not None:
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


def _layers(blocks: Params) -> List[Params]:
    """Every layer's params: views into the stacked block tensors, one
    `unbind` per leaf. Its backward is one `stack` per leaf, where indexing
    layer by layer would scatter each layer's gradient into a zero tensor of
    the whole stack."""
    flat = {k: v.unbind(0) for k, v in _flatten(blocks).items()}
    n = len(next(iter(flat.values())))
    return [_nest({k: v[i] for k, v in flat.items()}) for i in range(n)]


def _qkv(x, p, cfg: GPT2Config):
    qkv = matmul(x, p["wqkv"].to(cfg.dtype)) + p["bqkv"].to(cfg.dtype)
    return qkv.split(cfg.d_model, dim=-1)


def dense_attention(q, k, v, dtype):
    """Causal attention of the dense path, q,k,v [B, H, T, Dh]: scores from
    products in the compute dtype, softmax in f32 for stability."""
    T, Dh = q.shape[-2:]
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(Dh)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return probs @ v


def _dense(q, k, v, dtype, attn=None):
    """`attn` (this module's `dense_attention` by default) on plain tensors,
    or on each rank's local shard of DTensors: DTensor runs the products'
    forward but not the backward of the reshapes inside a 4-D matmul, and
    attention needs no collective."""
    attn = functools.partial(attn or dense_attention, dtype=dtype)
    if isinstance(q, DTensor):
        return on_local_shards(attn, q, k, v)
    return attn(q, k, v)


def _attention(x, p, cfg: GPT2Config):
    B, T, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    q, k, v = (constrain(t.reshape(B, T, H, Dh).transpose(1, 2),
                         "batch", "heads", "seq", None)
               for t in _qkv(x, p, cfg))
    impl = resolve_attn_impl(cfg.attn_impl, T, x.device)
    if impl == "dense":
        out = _dense(q, k, v, cfg.dtype)
    else:
        out = sharded_attention(impl, q, k, v)
    out = out.transpose(1, 2).reshape(B, T, D)
    return matmul(out, p["wo"].to(cfg.dtype)) + p["bo"].to(cfg.dtype)


def sharded_attention(impl: str, q, k, v):
    """Causal attention by the kernels: flash (K1-K3 on each rank's batch
    and head shard), ring (K1-K3 on chunk pairs of a sequence shard) or
    ulysses (all-to-all to whole sequences)."""
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, True)
    if impl in ("ring", "ulysses"):
        from ray_tpu_torch.ops import ring_attention

        return getattr(ring_attention, f"{impl}_attention")(q, k, v,
                                                            causal=True)
    raise ValueError(f"unknown attn_impl {impl!r}")


def _mlp(x, p, cfg: GPT2Config):
    h = matmul(x, p["wi"].to(cfg.dtype)) + p["bi"].to(cfg.dtype)
    h = constrain(h, "batch", "seq", "mlp")
    h = F.gelu(h, approximate="tanh")
    return matmul(h, p["wo"].to(cfg.dtype)) + p["bo"].to(cfg.dtype)


def _block(x, bp, cfg: GPT2Config):
    x = x + _attention(_layer_norm(x, bp["ln1"]), bp["attn"], cfg)
    x = constrain(x, "batch", "seq", "embed")
    x = x + _mlp(_layer_norm(x, bp["ln2"]), bp["mlp"], cfg)
    return constrain(x, "batch", "seq", "embed")


def embed(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B,T] int -> embeddings [B,T,D] (compute dtype). On a mesh the
    table is gathered whole before the lookup, as in the JAX model (its
    ZeRO-3 prefetch). The lookup is `F.embedding`, whose backward DTensor
    places in every torch the port runs on (indexing's index_put is not
    placed by torch 2.11's)."""
    T = tokens.shape[1]
    wte = constrain(params["wte"], None, None)
    x = F.embedding(tokens, wte) + params["wpe"][:T].unsqueeze(0)
    return constrain(x.to(cfg.dtype), "batch", "seq", "embed")


def unembed(params: Params, x: torch.Tensor, cfg: GPT2Config):
    """final hidden [B,T,D] -> logits [B,T,vocab] (tied embeddings)."""
    x = _layer_norm(x, params["ln_f"])
    return constrain(matmul(x, params["wte"].T.to(cfg.dtype)), "batch",
                     "seq", "vocab")


# aten products whose outputs a selective remat policy keeps: the x @ W
# products of a [B, T, D] activation by a weight run as mm (JAX: dots with no
# batch dims), the attention products q k^T and p v as bmm (batch dims)
_REMAT_SAVED = {
    "dots": ("mm", "addmm"),
    "dots_all": ("mm", "addmm", "bmm", "baddbmm"),
}


def _remat(fn, policy: Optional[str]):
    """fn under `torch.utils.checkpoint` with the named policy, or fn itself
    when the policy is None or nothing needs gradients (serving). Like the
    ``pallas_call`` under jax.checkpoint, the flash kernels are opaque to a
    selective policy and run again in the recompute."""
    if policy is None or not torch.is_grad_enabled():
        return fn
    fn = with_current_mesh(fn)    # the recompute may run on another thread
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy not in _REMAT_SAVED:
        raise ValueError(f"unknown remat_policy {policy!r}; "
                         f"expected full, {', '.join(_REMAT_SAVED)}")
    ops = [getattr(torch.ops.aten, name).default
           for name in _REMAT_SAVED[policy]]
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     ops))


def hidden_states(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B, T] int -> final hidden [B, T, D] (pre-unembed)."""
    x = embed(params, tokens, cfg)
    block_fn = _remat(functools.partial(_block, cfg=cfg),
                      cfg.remat_policy if cfg.remat else None)
    for bp in _layers(params["blocks"]):
        x = block_fn(x, bp)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B, T] int -> logits [B, T, vocab] (compute dtype)."""
    return unembed(params, hidden_states(params, tokens, cfg), cfg)


def _ce_chunk_sum(x, targets, w):
    logits = constrain(x @ w, "batch", "seq", "vocab")
    return torch.sum(token_nll(logits, targets))


def chunked_ce(params: Params, x: torch.Tensor, targets: torch.Tensor,
               cfg: GPT2Config) -> torch.Tensor:
    """Fused unembed + cross-entropy over ce_chunk-token slices, each under
    its own checkpoint: peak logits memory drops from [B, T, V] to
    [B, ce_chunk, V] in the forward and the backward. The same value as
    unembed + cross_entropy (f32 reductions)."""
    x = _layer_norm(x, params["ln_f"])
    w = params["wte"].T.to(cfg.dtype)                      # [D, V]
    B, T, _ = x.shape
    C = cfg.ce_chunk
    if T % C:
        raise ValueError(f"seq len {T} not divisible by ce_chunk={C}")
    chunk = _remat(_ce_chunk_sum, "full")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, C):
        total = total + chunk(x[:, c0:c0 + C], targets[:, c0:c0 + C], w)
    return total / (B * T)


def loss_fn(params: Params, batch: dict, cfg: GPT2Config) -> torch.Tensor:
    """Next-token cross-entropy. batch = {"tokens": [B,T+1]} or
    {"inputs": [B,T], "targets": [B,T]}."""
    inputs, targets = split_lm_batch(batch)
    if cfg.ce_chunk:
        return chunked_ce(params, hidden_states(params, inputs, cfg),
                          targets, cfg)
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
    logits, (cache,) = tp_prefill_chunk([params], [cache], tokens, pos0,
                                        length, active, cfg, None)
    return logits, cache


def _cache_attn_partial(h, p, ck, cv, writes, pos, cfg: GPT2Config):
    """One layer's attention on the KV cache for the heads `p` holds (all of
    them, or a tensor-parallel shard's): the chunk's K/V written into the
    cache lanes `writes` = (slot, lane, position), then attn @ wo without
    the output bias (a shard's partial sum)."""
    B, C, _ = h.shape
    Dh = cfg.head_dim
    H = p["wqkv"].shape[-1] // (3 * Dh)
    qkv = matmul(h, p["wqkv"].to(cfg.dtype)) + p["bqkv"].to(cfg.dtype)
    q, k, v = (t.reshape(B, C, H, Dh).transpose(1, 2)
               for t in qkv.split(H * Dh, dim=-1))          # [B, H, C, Dh]
    wb, wc, wt = writes
    # advanced indices around a slice: the indexed view is [n, H, Dh]
    ck[wb, :, wt] = k[wb, :, wc]
    cv[wb, :, wt] = v[wb, :, wc]
    # chunk lanes attend to everything written up to their own position
    # (causal within the chunk, full attention to the prefix)
    attn = _cache_attention(q, ck, cv, pos, Dh, cfg.dtype)
    attn = attn.transpose(1, 2).reshape(B, C, H * Dh)
    return attn @ p["wo"].to(cfg.dtype)


def _mlp_partial(h, p, cfg: GPT2Config):
    """The MLP on the d_ff columns `p` holds, without the output bias."""
    h = matmul(h, p["wi"].to(cfg.dtype)) + p["bi"].to(cfg.dtype)
    h = F.gelu(h, approximate="tanh")
    return matmul(h, p["wo"].to(cfg.dtype))


def tp_prefill_chunk(shards: List[Params], caches: List[dict],
                     tokens: torch.Tensor, pos0: torch.Tensor,
                     length: torch.Tensor, active: torch.Tensor,
                     cfg: GPT2Config, allreduce):
    """`prefill_chunk` over tensor-parallel shards (`tp_shards`), one a
    device, each with its heads' cache (`tp_init_caches`). Every device
    keeps the whole activation [B, C, D]; each layer's attention and MLP
    run on each shard's heads and d_ff columns, and `allreduce` (a list a
    device in, the same sum on every device out) adds the partial sums of
    the row-parallel wo products before the biases. One shard with
    `allreduce` None is `prefill_chunk`. Returns (logits from the first
    device, caches)."""
    B, C = tokens.shape
    T = caches[0]["k"].shape[3]
    xs, views = [], []
    for p, cache in zip(shards, caches):
        dev = cache["k"].device
        tok, p0, n, act = (t.to(dev) for t in (tokens, pos0, length, active))
        lane = torch.arange(C, device=dev)
        pos = p0[:, None] + lane[None, :]                        # [B, C]
        write = (lane[None, :] < n[:, None]) & act[:, None] & (pos < T) \
            & (pos >= 0)
        wb, wc = write.nonzero(as_tuple=True)                    # lanes kept
        writes = (wb, wc, pos[wb, wc])
        x = p["wte"][tok] + p["wpe"][pos.clamp(0, cfg.max_seq_len - 1)]
        xs.append(x.to(cfg.dtype))                               # [B, C, D]
        views.append((_layers(p["blocks"]), writes, pos))
    for i in range(cfg.n_layer):
        parts = [_cache_attn_partial(
            _layer_norm(x, layers[i]["ln1"]), layers[i]["attn"],
            cache["k"][i], cache["v"][i], writes, pos, cfg)
            for x, (layers, writes, pos), cache in zip(xs, views, caches)]
        parts = allreduce(parts) if allreduce is not None else parts
        xs = [x + (part + layers[i]["attn"]["bo"].to(cfg.dtype))
              for x, part, (layers, _, _) in zip(xs, parts, views)]
        parts = [_mlp_partial(_layer_norm(x, layers[i]["ln2"]),
                              layers[i]["mlp"], cfg)
                 for x, (layers, _, _) in zip(xs, views)]
        parts = allreduce(parts) if allreduce is not None else parts
        xs = [x + (part + layers[i]["mlp"]["bo"].to(cfg.dtype))
              for x, part, (layers, _, _) in zip(xs, parts, views)]
    x, p = xs[0], shards[0]
    last = (length.to(x.device) - 1).clamp(0, C - 1)
    x_last = _layer_norm(x[torch.arange(B, device=x.device), last],
                         p["ln_f"])
    return (x_last @ p["wte"].T.to(cfg.dtype)).float(), caches


# ---------------------------------------------------------------------------
# Tensor-parallel serving: one process, a shard a device (the JAX package's
# single-controller tp engine, where XLA places the shards and collectives)
# ---------------------------------------------------------------------------

def tp_shards(params: Params, cfg: GPT2Config, devices: List) -> List[Params]:
    """The params cut for tensor parallelism over `devices` by the tp
    entries of `param_logical_axes` under the default rules: "heads" and
    "mlp" dims split evenly, shard r taking heads [r·H/tp, (r+1)·H/tp) and
    the same d_ff slice. wqkv and bqkv are cut per head from q, k and v
    apart (their fused 3·d_model dim holds q, k and v one after the other,
    so a contiguous slice would not be a shard's heads). The "vocab" dim
    of the tied embedding stays whole on every device: a lookup and each
    logit's dot product over d_model are the same numbers whichever
    device holds the row, so the logits come from the first device alone
    with nothing to gather. Every other leaf (layer norms, wpe, the output
    biases, added once after the all-reduce) is whole on every device."""
    from ray_tpu_torch.parallel.mesh import DEFAULT_RULES

    tp, H, Dh = len(devices), cfg.n_head, cfg.head_dim
    if H % tp or cfg.d_ff % tp:
        raise ValueError(f"tensor_parallel_size={tp} must divide n_head "
                         f"({H}) and d_ff ({cfg.d_ff})")
    axes = _flatten(param_logical_axes(cfg))
    shards = []
    for r, dev in enumerate(devices):
        flat = {}
        for key, a in _flatten(params).items():
            dims = [i for i, n in enumerate(axes[key])
                    if n != "vocab" and DEFAULT_RULES.get(n) == "tp"]
            if dims and key.endswith(("attn/wqkv", "attn/bqkv")):
                d = dims[0]
                a = a.unflatten(d, (3, H, Dh)).narrow(d + 1, r * H // tp,
                                                      H // tp).flatten(d, d + 2)
            elif dims:
                a = a.chunk(tp, dims[0])[r]
            flat[key] = a.to(dev).contiguous()
        shards.append(_nest(flat))
    return shards


def tp_init_caches(cfg: GPT2Config, batch: int, max_len: Optional[int],
                   devices: List) -> List[dict]:
    """`init_cache` a shard: [n_layer, B, H/tp, T, Dh] on each device."""
    T = max_len or cfg.max_seq_len
    shape = (cfg.n_layer, batch, cfg.n_head // len(devices), T, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=d),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=d)}
            for d in devices]


def tp_decode_step(shards: List[Params], caches: List[dict],
                   tokens: torch.Tensor, pos: torch.Tensor,
                   active: torch.Tensor, cfg: GPT2Config, allreduce):
    """`decode_step` on tensor-parallel shards."""
    return tp_prefill_chunk(shards, caches, tokens[:, None], pos,
                            active.long(), active, cfg, allreduce)


def num_params(cfg: GPT2Config) -> int:
    d, f, L, V, S = (cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.vocab_size,
                     cfg.max_seq_len)
    per_block = (3 * d * d + 3 * d) + (d * d + d) + (2 * d * f + f + d) + 4 * d
    return V * d + S * d + L * per_block + 2 * d


def flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Approx training FLOPs/token (fwd+bwd ~ 6*N + attention term), the JAX
    package's count, for MFU against the card's own peak."""
    n = num_params(cfg) - cfg.vocab_size * cfg.d_model  # non-embedding
    attn = 12 * cfg.n_layer * cfg.d_model * seq_len
    return 6 * (n + cfg.vocab_size * cfg.d_model) + attn


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


# ---------------------------------------------------------------------------
# LoRA adapters
# ---------------------------------------------------------------------------

def apply_lora(params: Params, adapter: dict) -> Params:
    """Merge low-rank adapters into a copy of `params`.

    `adapter`: {"dotted.path": {"A": [..., D, r], "B": [..., r, K],
    "alpha": float}}; delta = (alpha / r) * A @ B, alpha defaulting to r.
    Stacked block params ([L, D, K]) take stacked A/B ([L, D, r],
    [L, r, K]) through a batched matmul. Only the dicts down each targeted
    path are copied and only the targeted leaves are new tensors: every
    other leaf is the base's own tensor, and no base tensor is written. A/B
    are cast to the leaf's dtype and device."""
    out = dict(params)
    for path, spec in adapter.items():
        keys = path.split(".")
        node = out
        for k in keys[:-1]:
            node[k] = dict(node[k]) if isinstance(node[k], dict) else node[k]
            node = node[k]
        leaf = node[keys[-1]]
        A = torch.as_tensor(spec["A"]).to(device=leaf.device, dtype=leaf.dtype)
        B = torch.as_tensor(spec["B"]).to(device=leaf.device, dtype=leaf.dtype)
        r = A.shape[-1]
        alpha = float(spec.get("alpha", r))
        delta = (alpha / r) * (A @ B)
        if delta.shape != leaf.shape:
            raise ValueError(
                f"LoRA delta shape {tuple(delta.shape)} != param "
                f"{tuple(leaf.shape)} at {path!r}")
        node[keys[-1]] = leaf + delta
    return out


def load_lora_npz(path: str) -> dict:
    """Adapter file: npz with `<dotted.path>.A`, `<dotted.path>.B` and
    optional `<dotted.path>.alpha` entries (local path or fsspec URI)."""
    from ray_tpu_torch.utils import fs

    with fs.open(path, "rb") as f:
        data = np.load(f)
        adapter: dict = {}
        for name in data.files:
            base, _, kind = name.rpartition(".")
            if kind not in ("A", "B", "alpha"):
                continue
            adapter.setdefault(base, {})[kind] = data[name]
    missing = [k for k, v in adapter.items() if "A" not in v or "B" not in v]
    if missing:
        raise ValueError(f"LoRA entries missing A/B pairs: {missing}")
    return adapter
