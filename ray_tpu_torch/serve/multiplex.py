"""Model multiplexing (counterpart of `ray_tpu/serve/multiplex.py`; reference
`python/ray/serve/multiplex.py` + `_private/multiplex.py`): a replica lazily
loads up to N models, LRU-evicts, and reports its loaded set so routers
prefer warm replicas."""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable, List, Optional

_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rtpu_multiplexed_model_id", default="")
_replica_reporter: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("rtpu_replica_reporter", default=None)


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller asked for."""
    return _model_id.get()


def _set_request_model_id(model_id: str):
    _model_id.set(model_id)


class _MultiplexWrapper:
    def __init__(self, fn: Callable, owner: Any,
                 max_num_models_per_replica: int):
        self._fn = fn
        self._owner = owner
        self._max = max_num_models_per_replica
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = asyncio.Lock()

    @property
    def loaded_model_ids(self) -> List[str]:
        return list(self._models)

    def _report(self):
        reporter = _replica_reporter.get()
        if reporter is not None:
            try:
                reporter(self.loaded_model_ids)
            except Exception:
                pass

    async def load_model(self, model_id: str) -> Any:
        async with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            if len(self._models) >= self._max:
                self._models.popitem(last=False)  # LRU eviction
            args = (self._owner, model_id) if self._owner is not None \
                else (model_id,)
            if inspect.iscoroutinefunction(self._fn):
                model = await self._fn(*args)
            else:
                model = self._fn(*args)
            self._models[model_id] = model
            self._report()
            return model

    def load_model_sync(self, model_id: str) -> Any:
        if model_id in self._models:
            self._models.move_to_end(model_id)
            return self._models[model_id]
        if len(self._models) >= self._max:
            self._models.popitem(last=False)
        args = (self._owner, model_id) if self._owner is not None \
            else (model_id,)
        model = self._fn(*args)
        self._models[model_id] = model
        self._report()
        return model

    def __call__(self, model_id: str):
        if inspect.iscoroutinefunction(self._fn):
            return self.load_model(model_id)
        return self.load_model_sync(model_id)


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a model-loader method: `@serve.multiplexed(...)
    async def get_model(self, model_id): ...`"""

    def deco(fn):
        attr = f"_rtpu_multiplex_{fn.__name__}"

        @functools.wraps(fn)
        def bound(self_or_model_id, *rest):
            # instance method: first arg is the owner instance
            if rest or not isinstance(self_or_model_id, str):
                owner, model_id = self_or_model_id, rest[0]
                wrapper = getattr(owner, attr, None)
                if wrapper is None:
                    wrapper = _MultiplexWrapper(fn, owner,
                                                max_num_models_per_replica)
                    setattr(owner, attr, wrapper)
            else:
                model_id = self_or_model_id
                wrapper = getattr(bound, "_wrapper", None)
                if wrapper is None:
                    wrapper = _MultiplexWrapper(fn, None,
                                                max_num_models_per_replica)
                    bound._wrapper = wrapper
            return wrapper(model_id)

        bound._rtpu_is_multiplexed = True
        return bound

    return deco


def loaded_model_ids_of(instance: Any) -> List[str]:
    ids: List[str] = []
    for name in dir(instance):
        if name.startswith("_rtpu_multiplex_"):
            wrapper = getattr(instance, name)
            if isinstance(wrapper, _MultiplexWrapper):
                ids.extend(wrapper.loaded_model_ids)
    return ids
