"""Streaming dataset ingest for trainers (counterpart of
`ray_tpu/train/ingest.py`; reference
`ray.train.get_dataset_shard` + streaming_split semantics, made
elastic-safe).

A `DatasetShard` is one worker's view of a dataset passed to a trainer
via `datasets={...}`. The contract is GLOBAL-BATCH deterministic:

- global batch i is the same rows at every world size (the dataset's
  deterministic order re-batched at `batch_size`);
- rank r of a world-w gang receives the row window
  [r * per, (r + 1) * per) of each global batch (per = batch_size // w),
  so the union across ranks is exactly the global batch — the usual
  data-parallel sharding of a fixed global batch shape (static
  per-rank shapes survive a resize).

Elastic resize semantics (the continuous-ingest drill): the controller
rebuilds every rank's shard with the new (rank, world) on each
generation; a train fn that checkpoints its step and resumes with
`start_batch=<resumed step>` consumes exactly one global batch per step
— across a mid-stream shrink or regrow, no batch is duplicated and none
is dropped, because batch identity is the global index, not the worker.

The underlying stream re-executes the pipeline from the source on each
(re)start and skips already-consumed batches; sources must therefore be
re-executable (read thunks / lineage-recoverable refs) — which is also
what the pipeline's own fault tolerance requires.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class DatasetShard:
    """One worker's elastic-safe view of a trainer dataset."""

    def __init__(self, dataset, rank: int, world_size: int):
        self._dataset = dataset
        self.rank = int(rank)
        self.world_size = max(int(world_size), 1)

    def iter_batches(self, *, batch_size: int, start_batch: int = 0,
                     batch_format: str = "numpy") -> Iterator[Any]:
        """Yield this rank's slice of every global batch from
        `start_batch` on. `batch_size` is the GLOBAL batch size and must
        divide evenly across the gang (static per-rank shapes)."""
        for _, batch in self.iter_global_batches(
                batch_size=batch_size, start_batch=start_batch,
                batch_format=batch_format):
            yield batch

    def iter_global_batches(self, *, batch_size: int, start_batch: int = 0,
                            batch_format: str = "numpy") -> Iterator[tuple]:
        """(global_index, rank slice) pairs — for train loops that key
        their step bookkeeping off the batch identity.

        Trailing partial global batches are DROPPED by construction: the
        fixed [rank*per, (rank+1)*per) windows of a short batch would
        hand ranks unequal (even empty) slices — exactly the ragged
        shapes an SPMD step cannot take — so there is no drop_last
        knob to get that wrong with."""
        if batch_size % self.world_size:
            raise ValueError(
                f"global batch_size {batch_size} must divide across "
                f"world_size {self.world_size}")
        per = batch_size // self.world_size
        lo, hi = self.rank * per, (self.rank + 1) * per
        for gi, batch in enumerate(self._dataset.iter_batches(
                batch_size=batch_size, batch_format=batch_format,
                drop_last=True)):
            if gi < start_batch:
                continue
            yield gi, self._slice(batch, lo, hi)

    @staticmethod
    def _slice(batch: Any, lo: int, hi: int) -> Any:
        if isinstance(batch, dict):
            return {k: v[lo:hi] for k, v in batch.items()}
        return batch[lo:hi]

    def __repr__(self):
        return (f"DatasetShard(rank={self.rank}/"
                f"{self.world_size}, {self._dataset!r})")


def build_shards(datasets: Optional[Dict[str, Any]], rank: int,
                 world_size: int) -> Dict[str, DatasetShard]:
    """Per-rank shard map for one worker-group generation (rebuilt on
    every elastic restart so rank/world stay current)."""
    return {name: DatasetShard(ds, rank, world_size)
            for name, ds in (datasets or {}).items()}
