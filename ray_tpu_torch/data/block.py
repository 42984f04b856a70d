"""Block format + accessor (counterpart of `ray_tpu/data/block.py`, kept as
the port's own copy).

Parity with `python/ray/data/block.py` + `_internal/arrow_block.py`: a
block is a column dict of numpy arrays (tabular; the case training uses —
token batches become tensors with one `torch.as_tensor`), a
`pyarrow.Table` (zero-copy parquet reads; sliced without copying,
converted to numpy only at consumption), or a plain list of rows. The
accessor hides the difference for slicing/concat/batching; barrier ops
(shuffle/sort/join) normalize to numpy columns first via
`to_numpy_columns`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]  # | pyarrow.Table


def is_arrow_block(block: Any) -> bool:
    try:
        import pyarrow as pa
    except ImportError:
        return False
    return isinstance(block, pa.Table)


def to_numpy_columns(block: Block) -> Block:
    """Arrow table -> numpy column dict; everything else passes through.
    Barrier ops and batch emission call this — the map/stream hot path
    keeps arrow blocks zero-copy."""
    if is_arrow_block(block):
        return {name: block.column(name).to_numpy(zero_copy_only=False)
                for name in block.column_names}
    return block


def block_nbytes(block: Block) -> int:
    """Approximate in-memory size; drives the streaming executor's
    memory-budget backpressure."""
    if is_arrow_block(block):
        return int(block.nbytes)
    if isinstance(block, dict):
        return int(sum(np.asarray(v).nbytes for v in block.values()))
    return 64 * len(block)  # rows of unknown size: rough per-row guess


def block_len(block: Block) -> int:
    if isinstance(block, dict):
        return len(next(iter(block.values()))) if block else 0
    if is_arrow_block(block):
        return block.num_rows
    return len(block)


def block_slice(block: Block, start: int, end: int) -> Block:
    if isinstance(block, dict):
        return {k: v[start:end] for k, v in block.items()}
    if is_arrow_block(block):
        return block.slice(start, end - start)  # zero-copy view
    return block[start:end]


def block_concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_len(b) > 0]
    if not blocks:
        return []
    if any(is_arrow_block(b) for b in blocks):
        if all(is_arrow_block(b) for b in blocks):
            import pyarrow as pa

            return pa.concat_tables(blocks)
        # mixed arrow/numpy: normalize each block ONCE, not per column
        blocks = [to_numpy_columns(b) for b in blocks]
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in keys}
    out: List[Any] = []
    for b in blocks:
        out.extend(b)
    return out


def block_to_batch(block: Block, batch_format: str) -> Any:
    if batch_format in ("numpy", "default"):
        return to_numpy_columns(block)
    if batch_format == "pandas":
        import pandas as pd

        if is_arrow_block(block):
            return block.to_pandas()
        if isinstance(block, dict):
            return pd.DataFrame(block)
        return pd.DataFrame({"item": block})
    if batch_format == "pyarrow":
        import pyarrow as pa

        if is_arrow_block(block):
            return block
        if isinstance(block, dict):
            return pa.table({k: pa.array(np.asarray(v))
                             for k, v in block.items()})
        return pa.table({"item": pa.array(block)})
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Any) -> Block:
    """Normalize a user-returned batch into a block."""
    if isinstance(batch, (dict, list)):
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        return batch
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return {c: batch[c].to_numpy() for c in batch.columns}
    except ImportError:
        pass
    try:
        import pyarrow as pa

        if isinstance(batch, pa.Table):
            return batch  # arrow is a first-class block format
    except ImportError:
        pass
    raise TypeError(f"unsupported batch type {type(batch)}")


def rows_of(block: Block) -> Iterable[Any]:
    if is_arrow_block(block):
        yield from block.to_pylist()
        return
    if isinstance(block, dict):
        keys = list(block)
        for i in range(block_len(block)):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block
