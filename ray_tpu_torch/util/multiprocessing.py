"""Drop-in `multiprocessing.Pool` built on tasks/actors.

Capability-equivalent of the reference's `ray.util.multiprocessing.Pool`
(`python/ray/util/multiprocessing/pool.py`): a process pool whose workers are
cluster actors, with the stdlib Pool surface (apply/apply_async, map/map_async,
starmap, imap, imap_unordered, close/terminate/join) so existing
multiprocessing code scales across nodes unchanged.
"""

from __future__ import annotations

import itertools
import multiprocessing
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import GetTimeoutError


@ray_tpu_torch.remote
class _PoolActor:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_batch(self, fn, batch, star):
        if star:
            return [fn(*args) for args in batch]
        return [fn(args) for args in batch]

    def run_apply(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class AsyncResult:
    """Matches `multiprocessing.pool.AsyncResult`."""

    def __init__(self, refs: List[Any], single: bool, chunked: bool,
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._single = single
        self._chunked = chunked
        if callback is not None or error_callback is not None:
            import threading

            def watch():
                try:
                    result = self.get()
                except Exception as e:
                    if error_callback is not None:
                        error_callback(e)
                else:
                    if callback is not None:
                        callback(result)

            threading.Thread(target=watch, daemon=True).start()

    def get(self, timeout: Optional[float] = None):
        try:
            out = ray_tpu_torch.get(self._refs, timeout=timeout)
        except GetTimeoutError:
            # stdlib contract: multiprocessing.TimeoutError (ProcessError
            # subclass), which is what drop-in callers catch
            raise multiprocessing.TimeoutError()
        if self._chunked:
            out = list(itertools.chain.from_iterable(out))
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            # stdlib contract: ValueError before completion, never block
            raise ValueError("AsyncResult is not ready")
        try:
            ray_tpu_torch.get(self._refs)
            return True
        except Exception:
            return False


class Pool:
    """Example:
        with Pool(processes=4) as p:
            assert p.map(abs, [-1, -2]) == [1, 2]
    """

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), maxtasksperchild: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 1)
        self._opts = opts
        self._init = (initializer, tuple(initargs))
        self._maxtasksperchild = maxtasksperchild
        self._actors = [self._spawn_actor() for _ in range(processes)]
        self._task_counts = [0] * processes
        self._next_idx = 0
        self._inflight: List[Any] = []
        self._closed = False

    def _spawn_actor(self):
        return _PoolActor.options(**self._opts).remote(*self._init)

    def _next_actor(self):
        """Round-robin with maxtasksperchild recycling (stdlib semantics:
        a worker is replaced after executing that many tasks)."""
        i = self._next_idx
        self._next_idx = (self._next_idx + 1) % self._processes
        if (self._maxtasksperchild is not None
                and self._task_counts[i] >= self._maxtasksperchild):
            ray_tpu_torch.kill(self._actors[i])
            self._actors[i] = self._spawn_actor()
            self._task_counts[i] = 0
        self._task_counts[i] += 1
        return self._actors[i]

    def _track(self, refs):
        # A single batched wait() per submission — per-ref wait calls were
        # O(inflight) control-plane round trips (quadratic over a large
        # map()), while deferring pruning would pin completed results.
        if self._inflight:
            _, pending = ray_tpu_torch.wait(self._inflight,
                                      num_returns=len(self._inflight),
                                      timeout=0)
            self._inflight = list(pending)
        self._inflight.extend(refs)
        return refs

    # -------------------------------------------------------------- apply
    def apply(self, func: Callable, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args=(), kwds=None,
                    callback: Optional[Callable] = None,
                    error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_running()
        actor = self._next_actor()
        ref = actor.run_apply.remote(func, tuple(args), kwds or {})
        self._track([ref])
        return AsyncResult([ref], single=True, chunked=False,
                           callback=callback, error_callback=error_callback)

    # ---------------------------------------------------------------- map
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize] for i in range(0, len(items), chunksize)]

    def _map_refs(self, func, iterable, chunksize, star):
        self._check_running()
        refs = []
        for batch in self._chunks(iterable, chunksize):
            refs.append(self._next_actor().run_batch.remote(func, batch, star))
        return self._track(refs)

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return AsyncResult(self._map_refs(func, iterable, chunksize, False),
                           single=False, chunked=True).get()

    def map_async(self, func, iterable, chunksize=None) -> AsyncResult:
        return AsyncResult(self._map_refs(func, iterable, chunksize, False),
                           single=False, chunked=True)

    def starmap(self, func, iterable, chunksize=None) -> List[Any]:
        return AsyncResult(self._map_refs(func, iterable, chunksize, True),
                           single=False, chunked=True).get()

    def starmap_async(self, func, iterable, chunksize=None) -> AsyncResult:
        return AsyncResult(self._map_refs(func, iterable, chunksize, True),
                           single=False, chunked=True)

    def imap(self, func, iterable, chunksize: int = 1):
        refs = self._map_refs(func, iterable, chunksize, False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, func, iterable, chunksize: int = 1):
        refs = self._map_refs(func, iterable, chunksize, False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # -------------------------------------------------------------- admin
    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)

    def join(self) -> None:
        """Blocks until every task submitted before close() finishes
        (stdlib contract), so terminate()/__exit__ cannot kill mid-task."""
        if not self._closed:
            raise ValueError("Pool is still running")
        if self._inflight:
            ray_tpu_torch.wait(self._inflight, num_returns=len(self._inflight))
            self._inflight = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
