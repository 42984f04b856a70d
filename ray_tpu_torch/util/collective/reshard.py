"""Host-side windowed reads, the part of `ray_tpu/util/collective/reshard.py`
that needs no sharding: `WindowedReader` (checkpoint restores read through
it) and `_HostReader`. numpy only.

`reshard`, `reshard_streaming` and `reshard_tree` take shardings, so they
come with the port's meshes (ROADMAP item 5).
"""

from __future__ import annotations

import numpy as np


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


class _HostReader:
    """`WindowedReader` facade over an in-memory ndarray."""

    def __init__(self, arr: np.ndarray):
        self._arr = arr
        self.shape = arr.shape
        self.dtype = arr.dtype

    def read(self, window) -> np.ndarray:
        return self._arr[tuple(slice(a, b) for a, b in window)]


__all__ = ["WindowedReader"]
