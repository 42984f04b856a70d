"""Shared language-model loss plumbing (counterpart of `ray_tpu/models/lm.py`)."""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.mesh import axis_size, constrain, current_mesh


def split_lm_batch(batch: dict):
    """{"tokens": [B,T+1]} or {"inputs","targets"} -> (inputs, targets)."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for an activation x [B, T, D]. The product flattens (B, T)
    into rows, which torch 2.11's DTensor refuses when T is sharded (a mesh
    with sp) unless T leads the flatten: a DTensor with only T sharded
    multiplies as [T, B, D], one with B sharded too as a batched product
    against w expanded over B (no flatten). The same products either way
    (row order does not enter a row's sums)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x @ w
    dims = {p.dim % x.ndim for p in x.placements if isinstance(p, Shard)}
    if 1 not in dims:
        return x @ w
    if 0 not in dims:
        return (x.transpose(0, 1) @ w).transpose(0, 1)
    return x @ w.expand(x.shape[0], *w.shape)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] per token, in f32. On a mesh the vocab
    dim of the logits is gathered whole first: DTensor's logsumexp of a
    vocab shard gathers it anyway, and its masked gather of the gold logit
    from a shard fails when checkpointing recomputes it."""
    logits = constrain(logits, "batch", "seq", None).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long().unsqueeze(-1))
    return logz - gold.squeeze(-1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits upcast to f32 for the softmax."""
    return torch.mean(token_nll(logits, targets))


def resolve_attn_impl(attn_impl: str, seq_len: int,
                      device: torch.device) -> str:
    """The attention implementation to run: dense, flash, ring or ulysses.

    auto -> ring when the current mesh shards the sequence axis (sp > 1),
    as in the JAX package; else flash on CUDA when seq_len is a multiple of
    128, dense otherwise and on the CPU. The JAX package's flash rule
    (from T >= 2048) was measured on a TPU and does not carry over; where
    flash overtakes dense on the H100 is still to be measured, and this
    rule is to be replaced by that measurement.
    """
    if attn_impl != "auto":
        return attn_impl
    mesh = current_mesh()
    if mesh is not None and axis_size(mesh, "sp") > 1:
        return "ring"
    if torch.device(device).type == "cuda" and seq_len % 128 == 0:
        return "flash"
    return "dense"
