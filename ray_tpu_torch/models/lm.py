"""Shared language-model loss plumbing (counterpart of `ray_tpu/models/lm.py`)."""

from __future__ import annotations

import torch


def split_lm_batch(batch: dict):
    """{"tokens": [B,T+1]} or {"inputs","targets"} -> (inputs, targets)."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits upcast to f32 for the softmax."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


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
