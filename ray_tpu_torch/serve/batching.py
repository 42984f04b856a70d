"""@serve.batch: dynamic request batching inside a replica (counterpart of
`ray_tpu/serve/batching.py`).

Parity with `python/ray/serve/batching.py`: calls block until a batch fills
(max_batch_size) or times out (batch_wait_timeout_s); the wrapped function
receives a list of requests and returns a list of results. Implemented with
a background batching thread (replica methods run on an actor thread pool,
so concurrent callers park on per-request events).

On the GPU this is the latency/throughput lever for serving: batched
requests become one batched forward (one kernel launch a layer) instead of
N small ones.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Callable, List, Optional


class _BatchItem:
    __slots__ = ("args", "event", "result", "error")

    def __init__(self, args):
        self.args = args
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: "queue.Queue[_BatchItem]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="serve-batcher")
                self._thread.start()

    def _loop(self):
        while True:
            batch = [self.queue.get()]
            deadline = self.timeout
            while len(batch) < self.max_batch_size:
                try:
                    batch.append(self.queue.get(timeout=deadline))
                except queue.Empty:
                    break
            try:
                results = self.fn([item.args for item in batch])
                if len(results) != len(batch):
                    raise ValueError(
                        f"batched fn returned {len(results)} results for a "
                        f"batch of {len(batch)}")
                for item, r in zip(batch, results):
                    item.result = r
            except BaseException as e:  # noqa: BLE001 - fan error to callers
                for item in batch:
                    item.error = e
            for item in batch:
                item.event.set()

    def submit(self, args) -> Any:
        self._ensure_thread()
        item = _BatchItem(args)
        self.queue.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: `fn(self, items: list) -> list`; callers pass one item."""

    def deco(fn):
        attr = f"__batcher_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, item):
            batcher = getattr(self, attr, None)
            if batcher is None:
                batcher = _Batcher(lambda items: fn(self, items),
                                   max_batch_size, batch_wait_timeout_s)
                setattr(self, attr, batcher)
            return batcher.submit(item)

        wrapper._is_serve_batch = True
        return wrapper

    return deco(_fn) if _fn is not None else deco
