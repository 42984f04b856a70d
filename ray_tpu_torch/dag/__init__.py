"""Lazy DAGs over tasks/actors + compiled execution over shm channels.

Capability parity with the reference's `ray.dag` (`python/ray/dag/`,
SURVEY §3.7): `.bind()` builds the graph; `.execute()` runs it eagerly as
tasks/actor calls; `.experimental_compile()` lowers actor-method pipelines
to long-running per-actor loops connected by native mutable shm channels
(ray_tpu_torch/csrc/channel.cc), replacing per-call RPCs with condvar
wakes. Counterpart of `ray_tpu.dag`, with the same exports; it imports no
torch (the head and the control plane load none).
"""

from ray_tpu_torch.dag.channel import Channel, ChannelClosedError
from ray_tpu_torch.dag.nodes import (ClassMethodNode, DAGNode, FunctionNode,
                                     InputNode, MultiOutputNode)
from ray_tpu_torch.dag.compiled import CompiledDAG

__all__ = [
    "Channel",
    "ChannelClosedError",
    "CompiledDAG",
    "DAGNode",
    "FunctionNode",
    "ClassMethodNode",
    "InputNode",
    "MultiOutputNode",
]
