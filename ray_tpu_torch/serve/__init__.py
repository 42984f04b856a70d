"""ray_tpu_torch.serve: model serving — controller, replicas, HTTP proxy,
routing, batching, multiplexing, autoscaling, LLM deployments (counterpart
of `ray_tpu/serve`, with the same exports).

The control plane (controller, proxy, router, handle, api, autoscaling,
batching, multiplex, live signals) imports no torch: only the user's
callable inside a replica does. So do the compiled ingress chain
(`CompiledServeChain`, `ChainResponse`) and the gRPC ingress
(`start_grpc`, which imports grpc when it starts).
"""

from ray_tpu_torch.serve.api import (Deployment, delete, deployment,
                                     get_deployment_handle, run, shutdown,
                                     start, status)
from ray_tpu_torch.serve.autoscaling import AutoscalingConfig
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.compiled_chain import (ChainResponse,
                                                CompiledServeChain)
from ray_tpu_torch.serve.grpc_proxy import start_grpc
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.live_signals import SLOConfig
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed


__all__ = [
    "Deployment", "deployment", "run", "delete", "shutdown", "start",
    "start_grpc",
    "status", "get_deployment_handle", "AutoscalingConfig", "SLOConfig",
    "batch",
    "DeploymentHandle", "DeploymentResponse", "multiplexed",
    "get_multiplexed_model_id",
    "CompiledServeChain", "ChainResponse",
]
