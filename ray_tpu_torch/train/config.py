"""Train configuration dataclasses (counterpart of
`ray_tpu/train/config.py`).

Parity with the reference's AIR/Train v2 configs
(`python/ray/train/v2/api/config.py` ScalingConfig,
`python/ray/air/config.py` RunConfig/FailureConfig/CheckpointConfig). Where
the JAX package's `ScalingConfig` asks for TPU chips (`use_tpu`,
`chips_per_worker`), the port's asks for GPUs (`use_gpu`,
`gpus_per_worker`): one card a worker by default, since the port trains on
the card unless asked for the CPU (`use_gpu=False`). A TPU slice
(`topology`) is refused until the slice reservation is ported (ROADMAP
item 21).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass
class ElasticConfig:
    """Elastic fault-tolerance policy for a worker group with an elastic
    range (`min_workers` < `num_workers`).

    The controller subscribes to the head's death-event plane
    (actor_state / node_state pubsub, the push side of the flight
    recorder's lease-event stream) so a daemon or worker kill interrupts
    the run in event time, not at the next poll timeout; the group is
    fenced by the cluster epoch + a per-start generation, reshaped to
    the surviving capacity, restored from the latest (resharding-capable)
    checkpoint, and — once capacity returns — grown back to
    `num_workers` at the next checkpoint boundary.
    """

    # how long a restart may wait for min_workers' worth of resources to
    # appear before giving up to the normal failure path
    schedule_wait_s: float = 60.0
    # capacity-watcher cadence while running below num_workers
    scale_up_check_interval_s: float = 2.0
    # after a graceful-stop (resize) request, how long workers get to
    # reach their next checkpoint boundary before being restarted anyway
    resize_grace_s: float = 60.0
    # grow back to num_workers at the next checkpoint boundary when the
    # cluster regains capacity (False: finish the run at reduced size)
    regrow: bool = True
    # fenced restarts (cluster-epoch changed under the group — e.g. a
    # head restart invalidated the grants it ran under) allowed before
    # erroring; these are environmental, not training failures, so they
    # have their own budget separate from FailureConfig.max_failures
    max_fenced_restarts: int = 5


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    Each worker holds `gpus_per_worker` GPUs (1 by default) and trains on
    the first of them (`worker_device`); `use_gpu=False` asks for the CPU
    instead. `topology` names a TPU slice in the JAX package; the port
    refuses it (ROADMAP item 21).
    """

    num_workers: int = 1
    # elastic range (reference elastic ScalingPolicy): when set, the
    # controller sizes each (re)start to the resources actually
    # available, between min_workers and num_workers — a shrunken
    # cluster restarts smaller instead of waiting, and grows back on the
    # next restart
    min_workers: Optional[int] = None
    use_gpu: bool = True
    topology: Optional[str] = None
    gpus_per_worker: Optional[int] = None   # default: one card a worker
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # elastic policy knobs; defaults apply whenever min_workers is set
    elastic: Optional[ElasticConfig] = None

    def elastic_config(self) -> ElasticConfig:
        return self.elastic or ElasticConfig()

    @property
    def is_elastic(self) -> bool:
        return bool(self.min_workers) and self.min_workers < self.num_workers

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.gpus_per_worker or 1)
        if not self.use_gpu and not res:
            res = {"CPU": 1.0}
        return res

    def worker_device(self, local_rank: int) -> str:
        """The device of the worker whose rank among the gang's workers on
        its node is `local_rank`: the first of its cards, which follow
        those of the lower local ranks (`cuda:<local rank x
        gpus_per_worker>`), or the CPU when `use_gpu` is False. The runtime
        assigns no device ids, so this is what keeps the workers of a node
        off each other's cards."""
        if not self.use_gpu:
            return "cpu"
        return f"cuda:{local_rank * (self.gpus_per_worker or 1)}"


@dataclasses.dataclass
class FailureConfig:
    """max_failures: whole-group restarts allowed before erroring (reference
    v2/_internal/execution/failure_handling/default.py)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Top-K retention: keep `num_to_keep` checkpoints (all when None),
    ranked by `checkpoint_score_attribute` of their metrics in
    `checkpoint_score_order` ("max" or "min"), or by recency when no
    attribute is named."""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser("~/ray_tpu_results")
        name = self.name or "train_run"
        return os.path.join(base, name)
