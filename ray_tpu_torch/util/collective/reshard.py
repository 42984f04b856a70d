"""Portable array resharding (counterpart of
`ray_tpu/util/collective/reshard.py`): the two places meshes change shape,
checkpoint restore under another world size and `adaptive_mesh_config`
reshapes after an elastic shrink or regrow.

A destination is a `parallel.mesh.Sharding` (mesh, placements), the
counterpart of JAX's `NamedSharding`; the result is a `DTensor`. Two
schedules, picked by where the source lives:

- **same mesh** (a DTensor on the destination's mesh):
  `DTensor.redistribute`, the collectives DTensor plans (all-to-all,
  all-gather, local slices); no host bounce;
- **another mesh, or the host** (numpy, a plain tensor, or a DTensor on
  another mesh, gathered whole with `full_tensor` first): each rank takes
  only its own index window of the global array (`mesh.local_window`), so
  a rank's device holds one shard, never a full copy.

Round trips are bitwise (only placement changes). `reshard_streaming`
assembles the window chunk by chunk from a host source larger than host
memory (`WindowedReader`); `last_stream_stats` records its peak host bytes.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.utils.tree import leaves as _leaves
from ray_tpu_torch.utils.tree import tree_map as _tree_map


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _from_window(local: torch.Tensor, shape, dst) -> Any:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local, dst.mesh, dst.placements, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def reshard(arr: Any, dst_sharding, *, src_sharding=None):
    """Redistribute `arr` (numpy, a tensor or a DTensor) to `dst_sharding`
    (a `parallel.mesh.Sharding`); returns a DTensor.

    `src_sharding` is accepted for API symmetry; the source layout is read
    off the array itself (a DTensor knows its placements, anything else is
    host-global). Every rank of the destination mesh calls this with the
    same global array; a DTensor on another mesh is gathered on its own
    mesh first, which every rank of that mesh must join."""
    from torch.distributed.tensor import DTensor

    del src_sharding
    mesh, placements = dst_sharding
    if isinstance(arr, DTensor):
        if arr.device_mesh == mesh:
            return arr.redistribute(mesh, placements)
        arr = arr.full_tensor()
    t = torch.as_tensor(arr)
    win = mesh_lib.local_window(t.shape, mesh, placements)
    local = t[win].to(_mesh_device(mesh), copy=True).contiguous()
    return _from_window(local, t.shape, dst_sharding)


class WindowedReader:
    """Duck-typed host source: `.shape`/`.dtype` plus `.read(window)`
    assembling the requested global index window from lazily-loaded chunk
    blobs.

    `chunks` is [(window, key)] in global coordinates
    (window = ((start, stop), ...) per dim); `loader(key, r0, r1)` must
    return rows [r0, r1) of that chunk's LEADING dim as an ndarray — e.g. a
    seek-read of a checkpoint npz member.
    """

    def __init__(self, shape, dtype, chunks, loader):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self._chunks = [(tuple((int(a), int(b)) for a, b in win), key)
                        for win, key in chunks]
        self._loader = loader

    def read(self, window) -> np.ndarray:
        window = tuple((int(a), int(b)) for a, b in window)
        out = np.zeros([b - a for a, b in window], self.dtype)
        if not window:  # scalar leaf: any chunk IS the value
            for _, key in self._chunks:
                out[...] = np.asarray(self._loader(key, 0, 1)).reshape(())
            return out
        for cwin, key in self._chunks:
            inter = tuple((max(a, ca), min(b, cb))
                          for (a, b), (ca, cb) in zip(window, cwin))
            if any(a >= b for a, b in inter):
                continue
            r0, r1 = inter[0][0] - cwin[0][0], inter[0][1] - cwin[0][0]
            rows = np.asarray(self._loader(key, r0, r1))
            sub = rows[(slice(None),) + tuple(
                slice(a - ca, b - ca) for (a, b), (ca, _) in
                zip(inter[1:], cwin[1:]))]
            out[tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in
                      zip(inter, window))] = sub
        return out


# Instrumentation for the most recent reshard_streaming call: peak bytes of
# live host chunk buffers (the budget the tests assert), chunk count,
# distinct destination windows (one a rank: a process addresses one
# device). Module-level on purpose: its callers (tests, benches) reshard
# serially.
last_stream_stats: dict = {}


def reshard_streaming(src: Any, dst_sharding, *, chunk_bytes: int,
                      max_in_flight: int = 2, out_dtype=None):
    """`reshard` for leaves larger than host memory: this rank's window is
    assembled CHUNK BY CHUNK instead of sliced from a materialized global
    array.

    `src` is an ndarray or a duck-typed reader (`.shape`/`.dtype`/
    `.read(window)`, see `WindowedReader`). The window is split along its
    leading dim into row chunks of at most `chunk_bytes`; a
    `max_in_flight`-deep prefetch overlaps the next chunk's host read with
    the current chunk's copy to the device, so peak host memory is about
    `max_in_flight * chunk_bytes` (down to one row) rather than the leaf
    size. Chunks are copied into their rows of the shard on the device:
    the result is bitwise-equal to `reshard` of the same data. `out_dtype`
    converts per chunk."""
    reader = src if hasattr(src, "read") else _HostReader(np.asarray(src))
    shape = tuple(int(n) for n in reader.shape)
    mesh, placements = dst_sharding
    win = tuple((s.start, s.stop)
                for s in mesh_lib.local_window(shape, mesh, placements))
    local = stream_window(reader, win, _mesh_device(mesh),
                          chunk_bytes=chunk_bytes,
                          max_in_flight=max_in_flight, out_dtype=out_dtype)
    return _from_window(local, shape, dst_sharding)


def stream_window(reader, window, device, *, chunk_bytes: int,
                  max_in_flight: int = 2, out_dtype=None) -> torch.Tensor:
    """The global index `window` ((start, stop) a dim) of `reader` as a
    tensor on `device`, read in row chunks of at most `chunk_bytes` with a
    `max_in_flight`-deep prefetch (`reshard_streaming`'s schedule, which
    records its stats in `last_stream_stats`)."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    max_in_flight = max(1, int(max_in_flight))
    dtype = np.dtype(out_dtype) if out_dtype is not None else np.dtype(
        reader.dtype)
    if not window:
        a = np.asarray(reader.read(()), np.dtype(reader.dtype)).astype(
            dtype, copy=False).reshape(())
        last_stream_stats.clear()
        last_stream_stats.update(peak_host_bytes=a.nbytes, chunks=1,
                                 windows=1)
        return torch.from_numpy(a.copy()).to(device)

    (w0, w1), trailing = window[0], tuple(window[1:])
    row_bytes = dtype.itemsize * int(np.prod([b - a for a, b in trailing]))
    rows_per = max(1, chunk_bytes // max(1, row_bytes))
    tasks = [((r0, min(r0 + rows_per, w1)),) + trailing
             for r0 in range(w0, w1, rows_per)]
    out = torch.empty([b - a for a, b in window],
                      dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                      device=device)

    stats = {"peak_host_bytes": 0, "chunks": 0, "windows": 1}
    live = {"bytes": 0}
    lock = threading.Lock()

    def _read(sub):
        a = np.ascontiguousarray(reader.read(sub))
        if a.dtype != dtype:
            a = a.astype(dtype)
        with lock:
            live["bytes"] += a.nbytes
            stats["peak_host_bytes"] = max(stats["peak_host_bytes"],
                                           live["bytes"])
        return a

    with ThreadPoolExecutor(max_workers=max_in_flight) as pool:
        q: deque = deque()
        ti = 0

        def _fill():
            nonlocal ti
            while len(q) < max_in_flight and ti < len(tasks):
                q.append((tasks[ti], pool.submit(_read, tasks[ti])))
                ti += 1

        _fill()
        while q:
            sub, fut = q.popleft()
            a = fut.result()
            # a blocking copy: the host buffer is free once it returns
            out[sub[0][0] - w0:sub[0][1] - w0].copy_(torch.from_numpy(a))
            with lock:
                live["bytes"] -= a.nbytes
            del a
            stats["chunks"] += 1
            _fill()
    last_stream_stats.clear()
    last_stream_stats.update(stats)
    return out


def reshard_tree(tree: Any, dst_shardings: Any, *,
                 src_shardings: Optional[Any] = None):
    """`reshard` over a tree of leaves (nested dicts, as the models'
    params); `dst_shardings` matches its structure, or is a single
    `Sharding` for every leaf."""
    del src_shardings
    if isinstance(dst_shardings, mesh_lib.Sharding):
        return _tree_map(lambda leaf: reshard(leaf, dst_shardings), tree)
    dst = iter(_leaves(dst_shardings))
    return _tree_map(lambda leaf: reshard(leaf, next(dst)), tree)


class _HostReader:
    """`WindowedReader` facade over an in-memory ndarray."""

    def __init__(self, arr: np.ndarray):
        self._arr = arr
        self.shape = arr.shape
        self.dtype = arr.dtype

    def read(self, window) -> np.ndarray:
        return self._arr[tuple(slice(a, b) for a, b in window)]


__all__ = ["reshard", "reshard_streaming", "stream_window", "reshard_tree",
           "WindowedReader", "last_stream_stats"]
