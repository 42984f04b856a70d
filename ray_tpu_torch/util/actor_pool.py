"""Actor pool utility: round-robin work distribution over a fixed set of actors.

Capability-equivalent of the reference's `ray.util.actor_pool.ActorPool`
(`python/ray/util/actor_pool.py`): submit/map work onto idle actors, consume
results in submission or completion order, grow/shrink the pool.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    """Pool of actor handles with map/submit semantics.

    Example:
        pool = ActorPool([Worker.remote() for _ in range(4)])
        results = list(pool.map(lambda a, v: a.double.remote(v), range(100)))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle_actors: List[Any] = list(actors)
        # in-flight: ObjectRef -> actor that produced it
        self._future_to_actor = {}
        # ordering for get_next(): index -> ref (+ reverse for O(1)
        # removal from get_next_unordered)
        self._index_to_future = {}
        self._future_to_index = {}
        self._next_task_index = 0
        self._next_return_index = 0
        # tasks buffered while no actor is free
        self._pending_submits = []

    # ------------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Schedule fn(actor, value) on an idle actor (or buffer it)."""
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._future_to_index[future] = self._next_task_index
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def _return_actor(self, actor) -> None:
        self._idle_actors.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    # --------------------------------------------------------------- next
    def get_next(self, timeout: float | None = None, ignore_if_timedout: bool = False):
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        future = self._index_to_future[self._next_return_index]
        if timeout is not None:
            done = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)[0]
            if not done:
                if ignore_if_timedout:
                    return None
                raise TimeoutError(f"no result within {timeout}s")
        future = self._index_to_future.pop(self._next_return_index)
        self._future_to_index.pop(future, None)
        self._next_return_index += 1
        actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: float | None = None):
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError(f"no result within {timeout}s")
        future = ready[0]
        actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        self._index_to_future.pop(self._future_to_index.pop(future), None)
        return ray_tpu_torch.get(future)

    # ---------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Lazy iterator of results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Lazy iterator of results in completion order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # --------------------------------------------------------- pool admin
    def push(self, actor) -> None:
        """Add an idle actor to the pool."""
        busy = set(self._future_to_actor.values())
        if actor in self._idle_actors or actor in busy:
            raise ValueError("actor already in pool")
        self._return_actor(actor)

    def pop_idle(self):
        """Remove and return an idle actor, or None if all are busy."""
        if self._idle_actors:
            return self._idle_actors.pop()
        return None
