"""DAG node types + .bind() surface (reference python/ray/dag/*_node.py).

Counterpart of `ray_tpu/dag/nodes.py`."""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    def __init__(self, args: Tuple = (), kwargs: Optional[dict] = None):
        self.uuid = uuid.uuid4().hex[:12]
        self.args = args
        self.kwargs = kwargs or {}

    # ---- traversal -------------------------------------------------------
    def upstream(self) -> List["DAGNode"]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def topo_order(self) -> List["DAGNode"]:
        seen: Dict[str, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node.uuid in seen:
                return
            seen[node.uuid] = node
            for up in node.upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order

    # ---- eager execution -------------------------------------------------
    def execute(self, *input_values) -> Any:
        """Run the DAG as ordinary tasks/actor calls; returns ObjectRef(s)
        (eager path, reference dag_node.py execute)."""
        results: Dict[str, Any] = {}
        for node in self.topo_order():
            results[node.uuid] = node._run(results, input_values)
        return results[self.uuid]

    def _materialize(self, value, results):
        if isinstance(value, DAGNode):
            return results[value.uuid]
        return value

    def _run(self, results, input_values):
        raise NotImplementedError

    def experimental_compile(self, channel_capacity: int = 4 << 20,
                             max_inflight: int = 2):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, channel_capacity=channel_capacity,
                           max_inflight=max_inflight)

    def __rshift__(self, other):  # small convenience for linear pipelines
        if callable(getattr(other, "bind", None)):
            return other.bind(self)
        raise TypeError(f"cannot chain into {other!r}")


class InputNode(DAGNode):
    """Placeholder for the runtime input; supports `with InputNode() as inp:`."""

    def __init__(self, index: int = 0):
        super().__init__()
        self.index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _run(self, results, input_values):
        return input_values[self.index]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self.remote_fn = remote_fn

    def _run(self, results, input_values):
        args = [self._materialize(a, results) for a in self.args]
        kwargs = {k: self._materialize(v, results)
                  for k, v in self.kwargs.items()}
        return self.remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self.actor_handle = actor_handle
        self.method = method

    def _run(self, results, input_values):
        args = [self._materialize(a, results) for a in self.args]
        kwargs = {k: self._materialize(v, results)
                  for k, v in self.kwargs.items()}
        return getattr(self.actor_handle, self.method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=tuple(outputs))
        self.outputs = outputs

    def _run(self, results, input_values):
        return [results[o.uuid] for o in self.outputs]
