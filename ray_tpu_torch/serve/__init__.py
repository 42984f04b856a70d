"""ray_tpu_torch.serve: model serving — controller, replicas, HTTP proxy,
routing, batching, multiplexing, autoscaling, LLM deployments (counterpart
of `ray_tpu/serve`, with the same exports).

The control plane (controller, proxy, router, handle, api, autoscaling,
batching, multiplex, live signals) imports no torch: only the user's
callable inside a replica does. The compiled ingress chain and the gRPC
ingress are ROADMAP item 18b: `CompiledServeChain`, `ChainResponse` and
`start_grpc` raise NotImplementedError until then.
"""

from ray_tpu_torch.serve.api import (Deployment, delete, deployment,
                                     get_deployment_handle, run, shutdown,
                                     start, status)
from ray_tpu_torch.serve.autoscaling import AutoscalingConfig
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.live_signals import SLOConfig
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

_ITEM_18B = "is ROADMAP item 18b, not ported to ray_tpu_torch yet"


def start_grpc(*args, **kwargs):
    """The gRPC ingress (`ray_tpu/serve/grpc_proxy.py`)."""
    raise NotImplementedError(f"serve.start_grpc {_ITEM_18B}")


class CompiledServeChain:
    """The compiled replica chain (`ray_tpu/serve/compiled_chain.py`)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"CompiledServeChain {_ITEM_18B}")


class ChainResponse:
    """A compiled chain's per-request future."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ChainResponse {_ITEM_18B}")


__all__ = [
    "Deployment", "deployment", "run", "delete", "shutdown", "start",
    "start_grpc",
    "status", "get_deployment_handle", "AutoscalingConfig", "SLOConfig",
    "batch",
    "DeploymentHandle", "DeploymentResponse", "multiplexed",
    "get_multiplexed_model_id",
    "CompiledServeChain", "ChainResponse",
]
