"""Dataset: lazy logical plan + streaming execution over the task runtime
(counterpart of `ray_tpu/data/dataset.py`, kept as the port's own copy).

Parity (miniature) with `python/ray/data/dataset.py` +
`_internal/execution/streaming_executor.py:61`: transformations build a lazy
plan; execution fuses consecutive per-block ops into one task per block and
streams blocks through with bounded in-flight tasks (backpressure = window
size). Barrier ops (repartition/shuffle/sort/groupby) materialize.

Blocks are numpy column dicts that become tensors with one
`torch.as_tensor` (`iter_torch_batches(device=...)` moves them to a card);
`iter_batches` re-batches across block boundaries so a fixed training batch
shape is always delivered.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, batch_to_block, block_concat,
                                      block_len, block_nbytes, block_slice,
                                      block_to_batch, rows_of,
                                      to_numpy_columns)

DEFAULT_WINDOW = 8  # initial in-flight block tasks (adapts to a byte budget)
# streaming memory budget (reference resource_budget_backpressure_policy):
# the in-flight window adapts so (avg block bytes x window) stays under it
from ray_tpu_torch.core import config as _config


def DATA_MEMORY_BUDGET() -> int:   # call-time: env/set() changes apply
    return _config.get("data_memory_budget_bytes")


MIN_WINDOW, MAX_WINDOW = 2, 64


# ----------------------------------------------------------- logical plan
@dataclasses.dataclass
class _Op:
    kind: str                  # "map_batches" | "map" | "filter" | "flat_map"
    fn: Callable               # | "repartition" | "shuffle" | "sort" | "limit"
    arg: Any = None
    batch_format: str = "numpy"
    # actor-pool compute (reference actor_pool_map_operator): fn is a class;
    # `concurrency` actors each hold one instance
    concurrency: int = 0


def _apply_op(block: Block, op: _Op) -> Block:
    if op.kind == "map_batches":
        batch = block_to_batch(block, op.batch_format)
        fn = op.fn() if isinstance(op.fn, type) else op.fn
        return batch_to_block(fn(batch))
    if op.kind == "map":
        return _rows_to_block([op.fn(r) for r in rows_of(block)])
    if op.kind == "filter":
        return _rows_to_block([r for r in rows_of(block) if op.fn(r)])
    if op.kind == "flat_map":
        out = []
        for r in rows_of(block):
            out.extend(op.fn(r))
        return _rows_to_block(out)
    raise ValueError(f"not a per-block op: {op.kind}")


def _zip_blocks(lb: Block, rb: Block) -> Block:
    lb, rb = to_numpy_columns(lb), to_numpy_columns(rb)

    def to_cols(b, side):
        if not isinstance(b, dict):
            b = _rows_to_block(list(b))
        if not isinstance(b, dict):
            raise ValueError(
                f"zip() requires tabular (column) data; {side} side has "
                "non-dict rows")
        return b

    merged = dict(to_cols(lb, "left"))
    for k, v in to_cols(rb, "right").items():
        merged[k if k not in merged else f"{k}_1"] = v
    return merged


def _join_blocks(lb: Block, rb: Block, on: str, how: str) -> Block:
    """Hash-join two co-partitioned blocks into row dicts."""
    lb, rb = to_numpy_columns(lb), to_numpy_columns(rb)
    import collections

    lrows = list(rows_of(lb))
    rrows = list(rows_of(rb))
    rindex: Dict[Any, List[dict]] = collections.defaultdict(list)
    for r in rrows:
        rindex[r[on]].append(r)
    lkeys = {r[on] for r in lrows}
    out: List[dict] = []
    lcols = set().union(*(r.keys() for r in lrows)) if lrows else set()
    rcols = set().union(*(r.keys() for r in rrows)) if rrows else set()

    def merge(l, r):
        row = dict(l or {k: None for k in lcols})
        for k, v in (r or {k: None for k in rcols}).items():
            if k == on:
                row[on] = row.get(on) if row.get(on) is not None else v
            else:
                row[k if k not in lcols or k == on else f"{k}_1"] = v
        return row

    for l in lrows:
        matches = rindex.get(l[on], [])
        if matches:
            out.extend(merge(l, r) for r in matches)
        elif how in ("left", "outer"):
            out.append(merge(l, None))
    if how in ("right", "outer"):
        for r in rrows:
            if r[on] not in lkeys:
                out.append(merge(None, r))
    return out


def _rows_to_block(items: List[Any]) -> Block:
    if items and isinstance(items[0], dict) and all(
            isinstance(r, dict) for r in items):
        keys = items[0].keys()
        if all(r.keys() == keys for r in items):
            return {k: np.asarray([r[k] for r in items]) for k in keys}
    return items


def _exec_chain(source, ops: List[_Op]) -> Block:
    block = source() if callable(source) else source
    for op in ops:
        block = _apply_op(block, op)
    return block


def _make_block_actor():
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class _BlockActorImpl:
        """One instance of a callable-class UDF; blocks stream through it
        (reference actor_pool_map_operator worker)."""

        def __init__(self, fn_cls):
            self.fn = fn_cls() if isinstance(fn_cls, type) else fn_cls

        def apply(self, block, batch_format):
            return batch_to_block(self.fn(block_to_batch(block, batch_format)))

    return _BlockActorImpl


class _BlockActorProxy:
    _cls = None

    @classmethod
    def remote(cls, fn):
        if cls._cls is None:
            cls._cls = _make_block_actor()
        return cls._cls.remote(fn)


_BlockActor = _BlockActorProxy


class Dataset:
    """Lazy, immutable; every transform returns a new Dataset."""

    def __init__(self, partitions: List[Any], ops: Optional[List[_Op]] = None,
                 parallelism: Optional[int] = None):
        # partitions: read thunks (callables) or ObjectRefs of blocks
        self._partitions = partitions
        self._ops = ops or []
        self._parallelism = parallelism

    # ----------------------------------------------------------- transforms
    def _with_op(self, op: _Op) -> "Dataset":
        return Dataset(self._partitions, self._ops + [op], self._parallelism)

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    concurrency: Optional[int] = None,
                    compute: Optional[str] = None, **_ignored) -> "Dataset":
        """`fn` may be a callable class (reference semantics): it is then
        instantiated once per pool actor and blocks stream through the pool."""
        use_actors = (isinstance(fn, type) or compute == "actors"
                      or (concurrency or 0) > 0)
        return self._with_op(_Op("map_batches", fn, batch_format=batch_format,
                                 concurrency=(concurrency or 2) if use_actors
                                 else 0))

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op(_Op("map", fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(_Op("filter", fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op(_Op("flat_map", fn))

    def union(self, *others: "Dataset") -> "Dataset":
        blocks = self._barrier_blocks()
        for o in others:
            blocks.extend(o._barrier_blocks())
        return Dataset(blocks, [], self._parallelism)

    def limit(self, n: int) -> "Dataset":
        out: List[Block] = []
        total = 0
        for block in self._stream_blocks():
            take = min(n - total, block_len(block))
            if take > 0:
                out.append(block_slice(block, 0, take))
                total += take
            if total >= n:
                break
        return Dataset(out, [], self._parallelism)

    def _shuffled(self, P: int, mode: str, **kw) -> "Dataset":
        """Two-stage distributed shuffle; blocks never touch the driver
        (ray_tpu_torch.data.shuffle). Falls back to local execution when no
        cluster is up."""
        import ray_tpu_torch
        from ray_tpu_torch.data import shuffle as shf

        if not ray_tpu_torch.is_initialized():
            # local fallback: same algorithm, thunks instead of tasks
            base = kw.get("seed")
            parts = [shf._map_partition(p, self._ops, P, mode,
                                        kw.get("key"),
                                        None if base is None
                                        else base + 7919 * i,
                                        kw.get("boundaries"))
                     for i, p in enumerate(self._partitions)]
            reduce_fn = kw.get("reduce_fn") or shf._reduce_concat
            extra = kw.get("reduce_extra_args", ())
            blocks = []
            for i in range(P):
                cols = [(pp[i] if P > 1 else pp) for pp in parts]
                blocks.append(reduce_fn(*extra, *cols))
            return Dataset(blocks, [], self._parallelism)
        refs = shf.shuffle_refs(self._partitions, self._ops, P, mode, **kw)
        return Dataset(refs, [], self._parallelism)

    def repartition(self, num_blocks: int) -> "Dataset":
        """Order-preserving (reference semantics): block i holds a
        contiguous range of the global row order."""
        from ray_tpu_torch.data import shuffle as shf

        lens = shf.block_lens(self._partitions, self._ops)
        n = sum(lens)
        sizes = [n // num_blocks + (1 if i < n % num_blocks else 0)
                 for i in range(num_blocks)]
        return self._reshard_to_sizes(sizes, lens=lens)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        from ray_tpu_torch.data import shuffle as shf

        P = max(len(self._partitions), 1)
        return self._shuffled(P, "random", seed=seed,
                              reduce_fn=shf._reduce_shuffled,
                              reduce_extra_args=(
                                  np.random.randint(1 << 31)
                                  if seed is None else seed + 13,))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample sort: range-partition on sampled boundaries,
        then sort each partition (partitions emerge globally ordered)."""
        import ray_tpu_torch
        from ray_tpu_torch.data import shuffle as shf

        P = max(len(self._partitions), 1)
        if ray_tpu_torch.is_initialized() and P > 1:
            bounds = shf.sample_boundaries(self._partitions, self._ops, key, P)
        else:
            allv = []
            for b in Dataset(list(self._partitions),
                             list(self._ops))._stream_blocks():
                if isinstance(b, dict):
                    allv.append(np.asarray(b[key]))
                else:
                    allv.append(np.asarray([r[key] for r in rows_of(b)]))
            cat = np.sort(np.concatenate(allv)) if allv else np.zeros(0)
            qs = np.linspace(0, max(len(cat) - 1, 0), P + 1)[1:-1].astype(int)
            bounds = cat[qs] if len(cat) else np.zeros(P - 1)
        ds = self._shuffled(P, "range", key=key, boundaries=bounds,
                            reduce_fn=shf._reduce_sorted,
                            reduce_extra_args=(key, descending))
        if descending:
            ds._partitions = list(reversed(ds._partitions))
        return ds

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join (reference `Dataset.join` /
        `_internal/execution/operators/join.py`): both sides hash-partition
        on `on`; co-partitions join in reduce tasks."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported how={how!r}")
        import ray_tpu_torch

        P = num_partitions or max(len(self._partitions),
                                  len(other._partitions), 1)
        left = self._shuffled(P, "hash", key=on)
        right = other._shuffled(P, "hash", key=on)

        def join_parts(lb, rb):
            return _join_blocks(lb, rb, on, how)

        if ray_tpu_torch.is_initialized():
            task = ray_tpu_torch.remote(join_parts).options(
                name="data_join", lineage=True, data_stage=True)
            refs = [task.remote(l, r) for l, r in
                    zip(left._partitions, right._partitions)]
            return Dataset(refs, [], self._parallelism)
        return Dataset([join_parts(l() if callable(l) else l,
                                   r() if callable(r) else r)
                        for l, r in zip(left._partitions, right._partitions)],
                       [], self._parallelism)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of equal-length tabular datasets (reference
        `Dataset.zip`); the right side is resharded once to the left's
        block sizes, then blocks merge pairwise in tasks. Each side's op
        chain executes exactly once; only row counts reach the driver."""
        import ray_tpu_torch
        from ray_tpu_torch.data import shuffle as shf

        left = self.materialize()
        lsizes = shf.block_lens(left._partitions)
        rlens = shf.block_lens(other._partitions, other._ops)
        if sum(rlens) != sum(lsizes):
            raise ValueError("zip() requires equal row counts")
        right = other._reshard_to_sizes(lsizes, lens=rlens)

        if ray_tpu_torch.is_initialized():
            task = ray_tpu_torch.remote(_zip_blocks)
            return Dataset([task.remote(l, r) for l, r in
                            zip(left._partitions, right._partitions)], [],
                           self._parallelism)
        rblocks = list(Dataset(list(right._partitions), [])._stream_blocks())
        return Dataset([_zip_blocks(l() if callable(l) else l, r)
                        for l, r in zip(left._partitions, rblocks)], [],
                       self._parallelism)

    def _reshard_to_sizes(self, sizes: List[int],
                          lens: Optional[List[int]] = None) -> "Dataset":
        """Reshard so block i has exactly sizes[i] rows, preserving global
        row order (zip alignment + order-preserving repartition)."""
        from ray_tpu_torch.data import shuffle as shf

        lens = lens if lens is not None else shf.block_lens(
            self._partitions, self._ops)
        if sum(lens) != sum(sizes):
            raise ValueError("reshard requires equal row counts")
        bounds = np.cumsum(sizes)[:-1]  # searchsorted(.., 'right') boundaries
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
        import ray_tpu_torch

        P = len(sizes)
        if ray_tpu_torch.is_initialized():
            map_task = ray_tpu_torch.remote(shf._map_partition).options(
                num_returns=P, name="data_reshard_map", data_stage=True)
            reducer = ray_tpu_torch.remote(shf._reduce_concat).options(
                name="data_reshard_reduce", lineage=True, data_stage=True)
            map_out = []
            for src, off in zip(self._partitions, offsets):
                refs = map_task.remote(src, self._ops, P, "offset",
                                       None, int(off), bounds)
                map_out.append([refs] if P == 1 else refs)
            return Dataset([reducer.remote(*[m[p] for m in map_out])
                            for p in range(P)], [], self._parallelism)
        parts = [shf._map_partition(src, self._ops, P, "offset", None,
                                    int(off), bounds)
                 for src, off in zip(self._partitions, offsets)]
        return Dataset([shf._reduce_concat(*[(pp[p] if P > 1 else pp)
                                             for pp in parts])
                        for p in range(P)], [], self._parallelism)

    # ------------------------------------------------------------ execution
    def _segments(self):
        """Split the op chain at actor-pool ops: [task-ops] → actor-op →
        [task-ops] … (reference: TaskPoolMapOperator vs ActorPoolMapOperator
        stages of one streaming topology)."""
        segs: List[tuple] = []   # ("tasks", ops) | ("actor", op)
        cur: List[_Op] = []
        for op in self._ops:
            if op.concurrency:
                segs.append(("tasks", cur))
                segs.append(("actor", op))
                cur = []
            else:
                cur.append(op)
        segs.append(("tasks", cur))
        return segs

    def _stream_blocks(self) -> Iterator[Block]:
        """The streaming executor: fused per-block tasks (actor-pool stages
        pipelined between them), bounded in-flight window."""
        import time as _time

        import ray_tpu_torch

        if not self._partitions:
            return
        t0 = _time.time()
        nrows = 0
        use_tasks = ray_tpu_torch.is_initialized() and (
            len(self._partitions) > 1 or self._ops)
        if not use_tasks:
            from ray_tpu_torch.core.object_ref import ObjectRef

            for p in self._partitions:
                block = p() if callable(p) else p
                if isinstance(block, ObjectRef):
                    # a single-partition barrier output (e.g. sort of a
                    # 1-file dataset) is an ObjectRef even on this path
                    block = ray_tpu_torch.get(block)
                for op in self._ops:
                    block = _apply_op(block, op)
                nrows += block_len(block)
                yield block
            self._record_stats(len(self._partitions), nrows, _time.time() - t0)
            return

        from ray_tpu_torch.data.executor import (ActorStage, StreamingExecutor,
                                                 TaskStage)

        # physical plan: fuse adjacent task ops into one TaskStage, one
        # ActorStage per callable-class UDF (operator-graph Topology,
        # reference streaming_executor.py:61)
        stages: List[Any] = []
        for i, (kind, seg) in enumerate(self._segments()):
            if kind == "tasks":
                if seg or i == 0:
                    stages.append(TaskStage(seg))
            else:
                stages.append(ActorStage(seg))

        window = self._parallelism or DEFAULT_WINDOW
        # adaptive backpressure: unless the caller fixed parallelism, size
        # the input window by the byte budget as completed-block sizes
        # come in — a fixed window of 8 is 8x too much memory for GB
        # blocks and 8x too little parallelism for KB blocks
        adapt = self._parallelism is None
        state = {"window": window, "bytes": 0, "blocks": 0}

        def input_window() -> int:
            if adapt and state["blocks"]:
                avg = max(state["bytes"] // state["blocks"], 1)
                state["window"] = min(MAX_WINDOW, max(
                    MIN_WINDOW, int(DATA_MEMORY_BUDGET() // avg)))
            self._last_window = state["window"]  # introspection
            return state["window"]

        executor = StreamingExecutor(stages, list(self._partitions),
                                     input_window)
        self._last_executor = executor   # per-op stats for stats()/tests
        emitted = 0
        results: Dict[int, Any] = {}
        try:
            for idx, ref in executor.run():
                block = ray_tpu_torch.get(ref)
                state["bytes"] += block_nbytes(block)
                state["blocks"] += 1
                results[idx] = block
                # the partition's whole chain is consumed: retire its
                # lineage entries so intermediate blocks evict now (a
                # long pipeline's store footprint stays bounded by the
                # window, not the lineage cap)
                executor.release_partition(idx, final_ref=ref)
                # emit in order (deterministic, like ordered execution)
                while emitted in results:
                    block = results.pop(emitted)
                    nrows += block_len(block)
                    yield block
                    emitted += 1
        finally:
            # executor.run's finally kills pool actors on GeneratorExit
            # (limit()/take() abandoning the stream must not leak them)
            executor.close()
            self._record_stats(len(self._partitions), nrows,
                               _time.time() - t0)

    def _record_stats(self, nblocks: int, nrows: int, wall: float) -> None:
        self._last_stats = {"num_blocks": nblocks, "num_rows": nrows,
                            "wall_time_s": wall}

    def stats(self) -> str:
        """Execution stats of the last run (reference `Dataset.stats()`),
        including per-operator rows when the operator-graph executor ran."""
        st = getattr(self, "_last_stats", None)
        if st is None:
            return "Dataset not executed yet"
        out = (f"{st['num_blocks']} blocks, {st['num_rows']} rows in "
               f"{st['wall_time_s']:.3f}s "
               f"({st['num_rows'] / max(st['wall_time_s'], 1e-9):.0f} rows/s)")
        ex = getattr(self, "_last_executor", None)
        if ex is not None:
            for s in ex.per_op_stats():
                out += f"\n  {s.summary()}"
        return out

    def explain(self) -> str:
        """Logical op chain → physical stage plan (reference
        `ExecutionPlan`/logical-plan repr): adjacent per-block ops fuse
        into one task stage; callable-class UDFs become actor stages."""
        logical = " -> ".join(["Read"] + [o.kind for o in self._ops])
        phys = []
        for i, (kind, seg) in enumerate(self._segments()):
            if kind == "tasks":
                if seg or i == 0:
                    phys.append("TaskStage[" +
                                (",".join(o.kind for o in seg) or "read") +
                                "]")
            else:
                phys.append(f"ActorStage[{seg.kind} x{seg.concurrency}]")
        return f"logical: {logical}\nphysical: {' -> '.join(phys)}"

    def _barrier_blocks(self) -> List[Block]:
        return list(self._stream_blocks())

    # ----------------------------------------------------------- consumers
    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        carry: Optional[Block] = None
        for block in self._stream_blocks():
            if carry is not None:
                block = block_concat([carry, block])
                carry = None
            off = 0
            n = block_len(block)
            while n - off >= batch_size:
                yield block_to_batch(block_slice(block, off, off + batch_size),
                                     batch_format)
                off += batch_size
            if off < n:
                carry = block_slice(block, off, n)
        if carry is not None and not drop_last:
            yield block_to_batch(carry, batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           dtypes=None, device=None) -> Iterator[Any]:
        """iter_batches with torch-tensor conversion (reference
        `Dataset.iter_torch_batches`): column dicts become dicts of
        tensors, optionally cast/moved."""
        import torch

        def to_t(v):
            t = torch.as_tensor(np.ascontiguousarray(v))
            if dtypes is not None:
                t = t.to(dtypes)
            if device is not None:
                t = t.to(device)
            return t

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            if isinstance(batch, dict):
                yield {k: to_t(v) for k, v in batch.items()}
            else:
                yield to_t(np.asarray(batch))

    def iter_rows(self) -> Iterator[Any]:
        for block in self._stream_blocks():
            yield from rows_of(block)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_len(b) for b in self._stream_blocks())

    def schema(self) -> Optional[List[str]]:
        from ray_tpu_torch.data.block import is_arrow_block

        for block in self._stream_blocks():
            if is_arrow_block(block):
                return list(block.column_names)
            if isinstance(block, dict):
                return list(block)
            return None
        return None

    def materialize(self) -> "Dataset":
        return Dataset(self._barrier_blocks(), [], self._parallelism)

    def num_blocks(self) -> int:
        return len(self._partitions)

    # --------------------------------------------------------------- splits
    def split(self, n: int) -> List["Dataset"]:
        """Shard by partition round-robin (train ingest: one shard per
        worker; reference streaming_split)."""
        shards: List[List[Any]] = [[] for _ in range(n)]
        for i, p in enumerate(self._partitions):
            shards[i % n].append(p)
        return [Dataset(s, list(self._ops), self._parallelism) for s in shards]

    streaming_split = split

    # -------------------------------------------------------------- writers
    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        from ray_tpu_torch.utils import fs as _fs

        _fs.makedirs(path)
        for i, block in enumerate(self._stream_blocks()):
            table = block_to_batch(block, "pyarrow")
            with _fs.open(_fs.join(path, f"part-{i:05d}.parquet"),
                          "wb") as f:
                pq.write_table(table, f)

    def write_csv(self, path: str) -> None:
        """One CSV file per block (reference `Dataset.write_csv`)."""
        import csv

        from ray_tpu_torch.utils import fs as _fs

        _fs.makedirs(path)
        for i, block in enumerate(self._stream_blocks()):
            cols = to_numpy_columns(block)
            out = _fs.join(path, f"part-{i:05d}.csv")
            with _fs.open(out, "w", newline="") as f:
                if isinstance(cols, dict):
                    w = csv.writer(f)
                    keys = list(cols)
                    w.writerow(keys)
                    for row in zip(*(cols[k] for k in keys)):
                        w.writerow(row)
                elif cols and all(isinstance(r, dict) for r in cols):
                    # row blocks of dicts get REAL columns, not reprs
                    keys = sorted({k for r in cols for k in r})
                    w = csv.DictWriter(f, fieldnames=keys)
                    w.writeheader()
                    w.writerows(cols)
                else:
                    w = csv.writer(f)
                    w.writerow(["item"])
                    for r in cols:
                        w.writerow([r])

    def write_json(self, path: str) -> None:
        """One JSONL file per block (reference `Dataset.write_json`)."""
        import json as _json

        from ray_tpu_torch.utils import fs as _fs

        _fs.makedirs(path)

        def _py(v):
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, np.ndarray):
                return v.tolist()  # json-parseable, not a numpy repr
            return v

        for i, block in enumerate(self._stream_blocks()):
            out = _fs.join(path, f"part-{i:05d}.jsonl")
            with _fs.open(out, "w") as f:
                for row in rows_of(block):
                    if isinstance(row, dict):
                        row = {k: _py(v) for k, v in row.items()}
                    else:
                        row = {"item": _py(row)}
                    f.write(_json.dumps(row, default=str) + "\n")

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._partitions)}, "
                f"ops={[o.kind for o in self._ops]})")


def _block_groups(block: Block, key: str) -> Dict[Any, Block]:
    """Split one (already key-co-partitioned) block into per-key blocks."""
    import collections

    groups: Dict[Any, List[Any]] = collections.defaultdict(list)
    for row in rows_of(block):
        groups[row[key]].append(row)
    return {k: _rows_to_block(v) for k, v in sorted(groups.items(),
                                                    key=lambda kv: str(kv[0]))}


def _agg_partition(key, specs, block) -> Block:
    """Reduce-stage groupby: aggregate every key group in this hash
    partition. specs = [(col, op_name, out_name)] with op in
    count/sum/mean/min/max/std."""
    fns = {"sum": np.sum, "mean": np.mean, "min": np.min, "max": np.max,
           "std": np.std}
    rows = []
    for k, b in _block_groups(block, key).items():
        row = {key: k}
        for col, op, name in specs:
            if op == "count":
                row[name] = block_len(b)
            else:
                row[name] = fns[op](np.asarray(b[col]))
        rows.append(row)
    return _rows_to_block(rows)


def _map_groups_partition(key, fn, block) -> Block:
    outs = [batch_to_block(fn(block_to_batch(b, "numpy")))
            for _, b in _block_groups(block, key).items()]
    return block_concat(outs) if outs else []


class GroupedData:
    """Distributed groupby: hash-shuffle by key, then per-partition
    aggregation tasks (reference `hash_aggregate` operator) — each key's
    rows land in exactly one partition, so partial results are final."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg_ds(self, specs) -> Dataset:
        import functools

        P = max(min(len(self._ds._partitions), DEFAULT_WINDOW), 1)
        shuffled = self._ds._shuffled(P, "hash", key=self._key)
        return shuffled._with_op(_Op(
            "map_batches",
            functools.partial(_agg_partition_batch, self._key, specs)))

    def aggregate(self, *specs) -> Dataset:
        """specs: (col, op) or (col, op, out_name) tuples."""
        return self._agg_ds([(c, op, rest[0] if rest else f"{op}({c})")
                             for c, op, *rest in specs])

    def count(self) -> Dataset:
        return self._agg_ds([(None, "count", "count")])

    def sum(self, col: str) -> Dataset:
        return self._agg_ds([(col, "sum", f"sum({col})")])

    def mean(self, col: str) -> Dataset:
        return self._agg_ds([(col, "mean", f"mean({col})")])

    def min(self, col: str) -> Dataset:
        return self._agg_ds([(col, "min", f"min({col})")])

    def max(self, col: str) -> Dataset:
        return self._agg_ds([(col, "max", f"max({col})")])

    def std(self, col: str) -> Dataset:
        return self._agg_ds([(col, "std", f"std({col})")])

    def map_groups(self, fn: Callable) -> Dataset:
        import functools

        P = max(min(len(self._ds._partitions), DEFAULT_WINDOW), 1)
        shuffled = self._ds._shuffled(P, "hash", key=self._key)
        return shuffled._with_op(_Op(
            "map_batches",
            functools.partial(_map_groups_partition_batch, self._key, fn)))


def _agg_partition_batch(key, specs, batch):
    return block_to_batch(_agg_partition(key, specs, batch_to_block(batch)),
                          "numpy")


def _map_groups_partition_batch(key, fn, batch):
    return block_to_batch(_map_groups_partition(key, fn,
                                                batch_to_block(batch)),
                          "numpy")


# ------------------------------------------------------------- tfrecords IO
def _crc32c(data: bytes) -> int:
    """Software CRC-32C (Castagnoli) — TFRecord framing checksums."""
    global _CRC32C_TABLE
    try:
        table = _CRC32C_TABLE
    except NameError:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _write_tfrecords(self, path: str) -> None:
    """One TFRecord file of tf.train.Example per block (reference
    `Dataset.write_tfrecords`), rows encoded with the built-in protobuf
    wire writer — no tensorflow required; framing carries real masked
    CRC-32C so TF readers accept the files."""
    import struct

    from ray_tpu_torch.data.read_api import _row_to_tf_example
    from ray_tpu_torch.utils import fs as _fs

    _fs.makedirs(path)
    for i, block in enumerate(self._stream_blocks()):
        out = _fs.join(path, f"part-{i:05d}.tfrecords")
        with _fs.open(out, "wb") as f:
            for row in rows_of(block):
                if not isinstance(row, dict):
                    row = {"item": row}
                data = _row_to_tf_example(row)
                header = struct.pack("<Q", len(data))
                f.write(header)
                f.write(struct.pack("<I", _masked_crc(header)))
                f.write(data)
                f.write(struct.pack("<I", _masked_crc(data)))


Dataset.write_tfrecords = _write_tfrecords
