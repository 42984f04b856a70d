"""Dask-on-ray_tpu_torch scheduler shim.

Parity: `python/ray/util/dask/` (`ray_dask_get`) — execute a dask task
graph with ray_tpu_torch tasks as the execution engine, so
`dask.compute(..., scheduler=ray_dask_get)` fans the graph's independent
tasks over the cluster.

Dask graphs are plain dicts `{key: spec}` where a spec is a computable
task `(callable, arg...)`, a key reference, or a literal — we walk that
protocol directly, so the shim also works on hand-built graphs with no
dask installed (dask itself is only needed for `dask.compute`)."""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef


def _is_task(spec: Any) -> bool:
    return isinstance(spec, tuple) and spec and callable(spec[0])


def _toposort(dsk: Dict[Hashable, Any]) -> List[Hashable]:
    seen: Dict[Hashable, int] = {}   # 0=visiting, 1=done
    order: List[Hashable] = []

    def deps(spec):
        if _is_task(spec):
            for a in spec[1:]:
                yield from deps(a)
        elif isinstance(spec, list):
            for a in spec:
                yield from deps(a)
        elif isinstance(spec, Hashable) and spec in dsk:
            yield spec

    def visit(key):
        st = seen.get(key)
        if st == 1:
            return
        if st == 0:
            raise ValueError(f"cycle in dask graph at {key!r}")
        seen[key] = 0
        for d in deps(dsk[key]):
            visit(d)
        seen[key] = 1
        order.append(key)

    for k in dsk:
        visit(k)
    return order


@ray_tpu_torch.remote
def _run_spec(fn, *args):
    # top-level ObjectRef args resolve before invocation (normal task
    # semantics); dask also nests key refs inside LISTS ((sum, [a, b]))
    # which arrive as ObjectRefs — materialize those here
    def mat(a):
        if isinstance(a, list):
            return [mat(x) for x in a]
        if isinstance(a, ObjectRef):
            return ray_tpu_torch.get(a)
        return a

    return fn(*[mat(a) for a in args])


def ray_dask_get(dsk: Dict[Hashable, Any], keys, **_kwargs):
    """Dask scheduler entry point: materialize `keys` from graph `dsk`.
    Independent tasks run as concurrent ray_tpu_torch tasks; dependencies ride
    as ObjectRefs (never gathered onto the driver mid-graph)."""
    refs: Dict[Hashable, Any] = {}

    def resolve(spec):
        """spec -> (value-or-ref, is_ref)."""
        if _is_task(spec):
            fn = spec[0]
            args = [resolve(a) for a in spec[1:]]
            return _run_spec.remote(fn, *args)
        if isinstance(spec, list):
            return [resolve(a) for a in spec]
        if isinstance(spec, Hashable) and spec in refs:
            return refs[spec]
        return spec

    for key in _toposort(dsk):
        spec = dsk[key]
        if _is_task(spec):
            refs[key] = resolve(spec)
        elif isinstance(spec, Hashable) and spec in refs:
            refs[key] = refs[spec]
        else:
            refs[key] = spec

    def gather(k):
        if isinstance(k, list):
            return [gather(x) for x in k]
        v = refs[k]
        return ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v

    return gather(list(keys) if isinstance(keys, (list, tuple)) else keys)
