"""Mixture-of-Experts transformer (Mixtral-style) in PyTorch: top-k routing
with a capacity per expert, dense one-hot dispatch and combine, a SwiGLU per
expert, the load-balance and z losses (counterpart of `ray_tpu/models/moe.py`).

Attention and RMSNorm are the port's Llama ones (`models.llama`), as the JAX
module reuses its `llama`. Experts are stacked ``[n_experts, ...]``; the
experts' SwiGLU is one batched product over the expert axis where JAX
`vmap`s one expert's. Everything has static shapes: a token past its
expert's capacity is dropped (the residual stream carries it).

On a mesh the experts stack on the logical axis "expert" (ep). Under the
default rules the batch is not on ep, so every rank routes the same tokens,
`constrain` keeps its experts' slice of the dispatched inputs, and the
combine contracts the sharded expert axis into a partial sum that the
constraint on its output reduces: what the JAX model's rules give, with no
all-to-all.
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
from ray_tpu_torch.models import llama as _llama
from ray_tpu_torch.models.lm import cross_entropy, matmul, split_lm_batch
from ray_tpu_torch.parallel.mesh import constrain

Params = Dict[str, Any]  # nested dict of tensors

AUX_KEYS = ("aux_loss", "z_loss", "dropped_frac")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    d_model: int = 4096
    d_ff: int = 14336                # per-expert SwiGLU hidden size
    n_experts: int = 8
    experts_per_token: int = 2       # top-k routing
    capacity_factor: float = 1.25    # C = ceil(k*T/E * factor); past C drop
    aux_loss_weight: float = 0.01    # Switch load-balance loss
    z_loss_weight: float = 1e-3      # router logit z-loss
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attn_impl: str = "auto"
    tie_embeddings: bool = False

    # llama-block compatibility
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    @classmethod
    def preset(cls, name: str, **overrides) -> "MoEConfig":
        presets = {
            "mixtral-8x7b": dict(n_layer=32, n_head=32, n_kv_head=8,
                                 d_model=4096, d_ff=14336, n_experts=8,
                                 experts_per_token=2, vocab_size=32000),
            "moe-tiny": dict(n_layer=2, n_head=4, n_kv_head=2, d_model=128,
                             d_ff=256, n_experts=4, experts_per_token=2,
                             vocab_size=512, max_seq_len=128),
        }
        return cls(**{**presets[name], **overrides})


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: MoEConfig) -> Dict[str, tuple]:
    """Path-keyed leaf shapes, in sorted-key order (the JAX tree's)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return _llama._model_shapes(cfg, {
        **_llama._attn_shapes(cfg), "moe/router": (D, E),
        "moe/wd": (E, Fd, D), "moe/wg": (E, D, Fd), "moe/wu": (E, D, Fd)})


def init_params(generator: torch.Generator, cfg: MoEConfig,
                device=None) -> Params:
    """The JAX package's init (std 0.02, wo and the experts' wd scaled by
    1/sqrt(2*n_layer)), drawn from `generator` on its device."""
    return _llama._init(generator, cfg, param_shapes(cfg),
                        ("blocks/attn/wo", "blocks/moe/wd"), device)


def params_from_numpy(flat: Dict[str, np.ndarray],
                      cfg: Optional[MoEConfig] = None, device=None) -> Params:
    """As `llama.params_from_numpy`, with this family's shapes."""
    return _gpt2._params_from_flat(
        flat, param_shapes(cfg) if cfg is not None else None, cfg, device)


params_to_numpy = _gpt2.params_to_numpy


def param_logical_axes(cfg: MoEConfig) -> Params:
    """Logical axis names per param leaf (the JAX model's)."""
    return _llama._model_axes(cfg, {**_llama._attn_axes(), "moe": {
        "router": ("embed", None),       # tiny; replicated
        "wg": ("expert", "embed", "mlp"),
        "wu": ("expert", "embed", "mlp"),
        "wd": ("expert", "mlp", "embed"),
    }})


def param_specs(cfg: MoEConfig, rules=None) -> Params:
    return _gpt2._specs(param_logical_axes(cfg), rules)


# ---------------------------------------------------------------------------
# Sparse MoE layer (dense dispatch/combine einsum formulation)
# ---------------------------------------------------------------------------

def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = math.ceil(cfg.experts_per_token * n_tokens * cfg.capacity_factor
                  / cfg.n_experts)
    return max(int(c), 4)


def route(x, p, cfg: MoEConfig):
    """The router, in f32: (logits [B,T,E], probs [B,T,E], gate_vals
    [B,T,K] renormalised to sum to 1, gate_idx [B,T,K])."""
    logits = matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return logits, probs, gate_vals, gate_idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside [0, n) gives a zero row, as in
    jax.nn.one_hot."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def moe_layer(x, p, cfg: MoEConfig):
    """Sparse SwiGLU MoE. x [B,T,D] -> (out [B,T,D], aux metrics dict).

    Every token gets its top-k experts; a cumsum over (slot-major, then
    token) order gives each (token, slot) its place in its expert's queue,
    so slot 0 choices win capacity ties; places past the capacity C (per
    expert, per batch row) are dropped."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = expert_capacity(cfg, T)
    # on a mesh with sp the sequence is gathered first: the queues run over
    # each row's whole sequence, and DTensor cannot flatten a sharded
    # sequence into the slot-major order (the output is sharded again)
    x = constrain(x, "batch", None, "embed")
    logits, probs, gate_vals, gate_idx = route(x, p, cfg)

    assign = _one_hot(gate_idx, E)                              # [B,T,K,E]
    flat = assign.transpose(1, 2).reshape(B, K * T, E)          # slot-major
    pos_in_expert = torch.cumsum(flat, dim=1) - flat            # exact in f32
    pos_in_expert = pos_in_expert.reshape(B, K, T, E).transpose(1, 2)
    keep = assign * (pos_in_expert < C)                         # [B,T,K,E]

    slot_pos = torch.sum(pos_in_expert * assign, dim=-1).long()  # [B,T,K]
    pos_oh = _one_hot(slot_pos, C)                              # [B,T,K,C]
    dispatch = torch.einsum("btke,btkc->btec", keep, pos_oh)
    combine = torch.einsum("btke,btkc,btk->btec", keep, pos_oh, gate_vals)

    # expert inputs [E, B, C, D], then every expert's SwiGLU as one batched
    # product over the expert axis
    expert_in = torch.einsum("btec,btd->ebcd", dispatch.to(cfg.dtype), x)
    expert_in = constrain(expert_in, "expert", "batch", None, "embed")
    h = expert_in.reshape(E, B * C, D)
    g = torch.bmm(h, p["wg"].to(cfg.dtype))
    u = torch.bmm(h, p["wu"].to(cfg.dtype))
    expert_out = torch.bmm(F.silu(g) * u, p["wd"].to(cfg.dtype))
    expert_out = constrain(expert_out.reshape(E, B, C, D), "expert", "batch",
                           None, "embed")
    # the combine "btec,ebcd->btd" as one product per expert and a sum over
    # the expert axis, in f32: DTensor (torch 2.11) cannot flatten the
    # ep-sharded expert axis into the contraction the einsum makes
    out = torch.matmul(combine.to(cfg.dtype).permute(2, 0, 1, 3), expert_out)
    out = out.sum(0, dtype=torch.float32).to(cfg.dtype)
    out = constrain(out, "batch", "seq", "embed")

    # Switch load-balance loss E * sum_e f_e * p_e (f: fraction of tokens
    # routed, p: mean router probability), z-loss on the router logits
    frac = torch.mean(torch.sum(keep, dim=2), dim=(0, 1)) * (E / K)  # [E]
    mean_prob = torch.mean(probs, dim=(0, 1)) * E                    # [E]
    aux_loss = torch.mean(frac * mean_prob)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - torch.sum(keep) / (B * T * K)
    return out, {"aux_loss": aux_loss, "z_loss": z_loss,
                 "dropped_frac": dropped}


def _block(x, bp, cfg: MoEConfig):
    x = x + _llama.attention(
        _llama.rms_norm(x, bp["attn_norm"], cfg.norm_eps), bp["attn"], cfg)
    x = constrain(x, "batch", "seq", "embed")
    moe_out, aux = moe_layer(
        _llama.rms_norm(x, bp["mlp_norm"], cfg.norm_eps), bp["moe"], cfg)
    return constrain(x + moe_out, "batch", "seq", "embed"), aux


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            return_aux: bool = False):
    """tokens [B,T] int -> logits [B,T,vocab] (compute dtype), and with
    return_aux the aux metrics, each summed over the layers and divided by
    n_layer."""
    x = _llama.embed(params, tokens, cfg)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in AUX_KEYS}
    block_fn = _gpt2._remat(functools.partial(_block, cfg=cfg),
                            "full" if cfg.remat else None)
    for bp in _gpt2._layers(params["blocks"]):
        x, layer_aux = block_fn(x, bp)
        aux = {k: aux[k] + layer_aux[k] for k in AUX_KEYS}
    logits = _llama.unembed(params, x, cfg)
    aux = {k: v / cfg.n_layer for k, v in aux.items()}
    return (logits, aux) if return_aux else logits


def loss_fn(params: Params, batch: dict, cfg: MoEConfig) -> torch.Tensor:
    """cross-entropy + aux_loss_weight * aux_loss + z_loss_weight * z_loss."""
    inputs, targets = split_lm_batch(batch)
    logits, aux = forward(params, inputs, cfg, return_aux=True)
    ce = cross_entropy(logits, targets)
    return (ce + cfg.aux_loss_weight * aux["aux_loss"]
            + cfg.z_loss_weight * aux["z_loss"])


def num_params(cfg: MoEConfig) -> int:
    D, Fd, L, V, E = (cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.vocab_size,
                      cfg.n_experts)
    kv_dim = cfg.n_kv_head * cfg.head_dim
    per_block = (D * D * 2 + D * kv_dim * 2 + D * E + E * 3 * D * Fd + 2 * D)
    total = V * D + L * per_block + D
    if not cfg.tie_embeddings:
        total += D * V
    return total


def active_params(cfg: MoEConfig) -> int:
    """Params touched per token (experts_per_token of n_experts)."""
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    kv_dim = cfg.n_kv_head * cfg.head_dim
    K = cfg.experts_per_token
    per_block = (D * D * 2 + D * kv_dim * 2 + D * cfg.n_experts
                 + K * 3 * D * Fd + 2 * D)
    total = cfg.vocab_size * D + L * per_block + D
    if not cfg.tie_embeddings:
        total += D * cfg.vocab_size
    return total
