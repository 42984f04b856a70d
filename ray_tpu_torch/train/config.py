"""Training configuration (counterpart of `ray_tpu/train/config.py`).

Only `CheckpointConfig` is ported so far, for `train.checkpoint`'s
`CheckpointManager`; `ScalingConfig`, `RunConfig` and `FailureConfig` go
with the trainer (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class CheckpointConfig:
    """Top-K retention: keep `num_to_keep` checkpoints (all when None),
    ranked by `checkpoint_score_attribute` of their metrics in
    `checkpoint_score_order` ("max" or "min"), or by recency when no
    attribute is named."""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
