"""Distributed FIFO queue backed by an async actor.

Capability-equivalent of the reference's `ray.util.queue.Queue`
(`python/ray/util/queue.py`): a named asyncio.Queue living in a dedicated
actor, usable from any driver/worker, with blocking/non-blocking puts and
gets, batch variants, and shutdown.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._active = 0   # blocking puts/gets currently in flight

    async def put(self, item, timeout: Optional[float] = None):
        self._active += 1
        try:
            if timeout is None:
                await self._q.put(item)
                return True
            try:
                await asyncio.wait_for(self._q.put(item), timeout)
                return True
            except asyncio.TimeoutError:
                return False
        finally:
            self._active -= 1

    async def put_nowait(self, item):
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def put_nowait_batch(self, items: List[Any]):
        if self._q.maxsize and self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    async def get(self, timeout: Optional[float] = None):
        self._active += 1
        try:
            if timeout is None:
                return True, await self._q.get()
            try:
                return True, await asyncio.wait_for(self._q.get(), timeout)
            except asyncio.TimeoutError:
                return False, None
        finally:
            self._active -= 1

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def get_nowait_batch(self, num_items: int):
        if self._q.qsize() < num_items:
            return None
        return [self._q.get_nowait() for _ in range(num_items)]

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def drain(self) -> bool:
        """Graceful-shutdown barrier: resolves once no blocking put/get is
        in flight (the client caps the wait, so a forever-blocked get
        cannot hang shutdown)."""
        while self._active > 0:
            await asyncio.sleep(0.01)
        return True

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    """Driver/worker-shared FIFO queue.

    Example:
        q = Queue(maxsize=100)
        q.put(1); assert q.get() == 1
    """

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 64)
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def __reduce__(self):
        return _rebuild_queue, (self.actor, self.maxsize)

    # ---------------------------------------------------------------- put
    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full(f"put timed out after {timeout}s")

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full("batch does not fit in queue")

    # ---------------------------------------------------------------- get
    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty(f"get timed out after {timeout}s")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        out = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))
        if out is None:
            raise Empty(f"fewer than {num_items} items in queue")
        return out

    # -------------------------------------------------------------- admin
    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self, force: bool = False) -> None:
        """force=False waits for already-submitted actor calls to finish
        before killing the queue actor (reference semantics:
        `ray.util.queue.Queue.shutdown`); force=True kills immediately."""
        if not force:
            try:
                ray_tpu_torch.get(self.actor.drain.remote(), timeout=30)
            except Exception:
                pass
        ray_tpu_torch.kill(self.actor)


def _rebuild_queue(actor, maxsize):
    q = Queue.__new__(Queue)
    q.actor = actor
    q.maxsize = maxsize
    return q
