"""Shared language-model loss plumbing (counterpart of `ray_tpu/models/lm.py`)."""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.mesh import constrain


def split_lm_batch(batch: dict):
    """{"tokens": [B,T+1]} or {"inputs","targets"} -> (inputs, targets)."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


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
    """The attention implementation to run: dense or flash.

    auto -> flash on CUDA when seq_len is a multiple of 128, dense otherwise
    and on the CPU. The JAX package's rule (flash from T >= 2048) was measured
    on a TPU and does not carry over; where flash overtakes dense on the H100
    is still to be measured, and this rule is to be replaced by that
    measurement. ring and ulysses need the collective slice.
    """
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} needs the collective slice of the port")
    if attn_impl != "auto":
        return attn_impl
    if torch.device(device).type == "cuda" and seq_len % 128 == 0:
        return "flash"
    return "dense"
