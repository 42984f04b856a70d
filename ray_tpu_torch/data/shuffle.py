"""Distributed hash/range shuffle: map tasks partition, reduce tasks merge
(counterpart of `ray_tpu/data/shuffle.py`, kept as the port's own copy).

Parity: `python/ray/data/_internal/execution/operators/hash_shuffle.py` and
the push-based shuffle in `_internal/planner/exchange/` — a two-stage
all-to-all where no block ever lands on the driver:

  map stage:    one task per input block → P keyed sub-blocks
                (multi-return task, one ObjectRef per sub-block)
  reduce stage: one task per output partition ← the P-th ref of every map

The reduce task receives sub-blocks through the object store directly
(worker-to-worker), so the driver only handles ObjectRefs.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, block_concat, block_len,
                                      block_slice, block_to_batch, rows_of,
                                      to_numpy_columns)


def _partition_block(block: Block, assign: np.ndarray, P: int) -> List[Block]:
    """Split rows into P sub-blocks per the assignment vector."""
    block = to_numpy_columns(block)  # barriers materialize numpy
    out: List[Block] = []
    if isinstance(block, dict):
        for p in range(P):
            idx = np.nonzero(assign == p)[0]
            out.append({k: np.asarray(v)[idx] for k, v in block.items()})
    else:
        rows = list(block)
        buckets: List[List[Any]] = [[] for _ in range(P)]
        for r, p in zip(rows, assign):
            buckets[int(p)].append(r)
        out = buckets
    return out


def _hash_of(values) -> np.ndarray:
    """Stable vectorized hash (don't use Python hash(): salted per process)."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iub":
        v = arr.astype(np.uint64)
        v = (v ^ (v >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
        v = (v ^ (v >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
        return v ^ (v >> 33)
    import zlib

    return np.asarray([zlib.crc32(str(x).encode()) for x in arr],
                      dtype=np.uint64)


def _map_partition(source, ops, P: int, mode: str, key: Optional[str],
                   seed: Optional[int], boundaries):
    """Map-stage body: run the fused op chain, then split into P parts."""
    from ray_tpu_torch.data.dataset import _exec_chain

    block = to_numpy_columns(_exec_chain(source, ops))
    n = block_len(block)
    if n == 0:
        parts = _partition_block(block, np.zeros(0, np.int64), P)
    elif mode == "hash":
        if isinstance(block, dict):
            keys = block[key]
        else:
            keys = [r[key] for r in rows_of(block)]
        assign = (_hash_of(keys) % np.uint64(P)).astype(np.int64)
        parts = _partition_block(block, assign, P)
    elif mode == "random":
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, P, size=n)
        parts = _partition_block(block, assign, P)
    elif mode == "range":
        if isinstance(block, dict):
            keys = np.asarray(block[key])
        else:
            keys = np.asarray([r[key] for r in rows_of(block)])
        assign = np.searchsorted(np.asarray(boundaries), keys, side="right")
        parts = _partition_block(block, assign, P)
    elif mode == "round_robin":
        assign = np.arange(n) % P
        parts = _partition_block(block, assign, P)
    elif mode == "offset":
        # rows assigned by global row index against cumulative boundaries
        # (seed carries this block's global start offset; zip resharding)
        idx = int(seed or 0) + np.arange(n)
        assign = np.searchsorted(np.asarray(boundaries), idx, side="right")
        parts = _partition_block(block, assign, P)
    else:
        raise ValueError(mode)
    return tuple(parts) if P > 1 else parts[0]


def _reduce_concat(*parts):
    parts = [to_numpy_columns(p) for p in parts]
    return block_concat([p for p in parts if block_len(p)])


def _reduce_shuffled(seed, *parts):
    """Concat then permute rows — without this, rows keep their relative
    order inside each output partition and 'shuffled' data stays
    near-sorted (a silent training-data bug)."""
    block = _reduce_concat(*parts)
    n = block_len(block)
    perm = np.random.default_rng(seed).permutation(n)
    if isinstance(block, dict):
        return {k: np.asarray(v)[perm] for k, v in block.items()}
    rows = list(block)
    return [rows[i] for i in perm]


def _reduce_sorted(key, descending, *parts):
    block = _reduce_concat(*parts)
    if isinstance(block, dict):
        order = np.argsort(block[key], kind="stable")
        if descending:
            order = order[::-1]
        return {k: np.asarray(v)[order] for k, v in block.items()}
    return sorted(block, key=lambda r: r[key], reverse=descending)


def shuffle_refs(partitions: List[Any], ops: List[Any], P: int, mode: str,
                 *, key: Optional[str] = None, seed: Optional[int] = None,
                 boundaries=None,
                 reduce_fn: Optional[Callable] = None,
                 reduce_extra_args: tuple = ()) -> List[Any]:
    """Run the two-stage shuffle; returns P ObjectRefs of reduced blocks.

    Fault tolerance: map tasks are multi-return and head-submitted, so
    every sub-block has a lineage ledger entry; reduce tasks opt into
    out-of-band lineage (`lineage=True`, they ride the lease path). A
    node SIGKILLed mid-shuffle loses only its resident sub-blocks — the
    reduce tasks' dependency fetches park at the head, which re-runs
    exactly the map tasks whose outputs died (lazy reconstruction,
    surfaced as data_blocks_reconstructed_total), and the shuffle
    completes byte-identical."""
    import ray_tpu_torch

    map_task = ray_tpu_torch.remote(_map_partition).options(
        num_returns=P, name="data_shuffle_map", data_stage=True)
    reducer = ray_tpu_torch.remote(reduce_fn or _reduce_concat).options(
        name="data_shuffle_reduce", lineage=True, data_stage=True)
    map_out = []
    for i, src in enumerate(partitions):
        # salt the seed per map task: identical seeds would send row t of
        # every equal-sized block to the same partition
        task_seed = None if seed is None else seed + 7919 * i
        if mode == "random" and seed is None:
            task_seed = np.random.randint(1 << 31) + i
        refs = map_task.remote(src, ops, P, mode, key, task_seed, boundaries)
        map_out.append([refs] if P == 1 else refs)
    out = []
    for p in range(P):
        cols = [m[p] for m in map_out]
        out.append(reducer.remote(*reduce_extra_args, *cols))
    return out


def block_lens(partitions, ops=()) -> List[int]:
    """Row count per partition via tiny remote tasks (only ints reach the
    driver)."""
    import ray_tpu_torch

    def len_of(source, ops):
        from ray_tpu_torch.data.dataset import _exec_chain

        return block_len(_exec_chain(source, list(ops)))

    if not ray_tpu_torch.is_initialized():
        from ray_tpu_torch.data.dataset import _exec_chain

        return [block_len(_exec_chain(s, list(ops))) for s in partitions]
    task = ray_tpu_torch.remote(len_of)
    return ray_tpu_torch.get([task.remote(s, list(ops)) for s in partitions])


def sample_boundaries(partitions: List[Any], ops: List[Any], key: str,
                      P: int, sample_size: int = 256) -> np.ndarray:
    """Range-partition boundaries from per-block samples (the reference's
    sort sampling in `_internal/planner/exchange/sort_task_spec.py`)."""
    import ray_tpu_torch

    def sample_one(source, ops, key, k):
        from ray_tpu_torch.data.dataset import _exec_chain

        block = _exec_chain(source, ops)
        if isinstance(block, dict):
            vals = np.asarray(block[key])
        else:
            vals = np.asarray([r[key] for r in rows_of(block)])
        if len(vals) > k:
            vals = np.random.default_rng(0).choice(vals, size=k, replace=False)
        return vals

    task = ray_tpu_torch.remote(sample_one)
    samples = ray_tpu_torch.get([task.remote(s, ops, key, sample_size)
                           for s in partitions])
    allv = np.sort(np.concatenate([s for s in samples if len(s)]))
    if len(allv) == 0:
        return np.zeros(P - 1)
    qs = np.linspace(0, len(allv) - 1, P + 1)[1:-1].astype(int)
    return allv[qs]
