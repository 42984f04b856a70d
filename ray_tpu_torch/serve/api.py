"""Serve public API: @deployment, run, get handle, shutdown (counterpart of
`ray_tpu/serve/api.py`).

Parity with `python/ray/serve/api.py` (`serve.run` :665, `@serve.deployment`)
and `deployment.py`. The controller is a named actor
("serve-controller"), found or created on demand like the reference's
detached ServeController.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.autoscaling import AutoscalingConfig
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

CONTROLLER_NAME = "serve-controller"


@dataclasses.dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Optional[Dict[str, Any]] = None
    max_ongoing_requests: int = 8
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    init_args: tuple = ()
    init_kwargs: Optional[dict] = None
    # GPUs every replica of this deployment pins itself to
    # (CUDA_VISIBLE_DEVICES, set in the replica before CUDA starts), where
    # the JAX package has visible_chips; None leaves the replica's view
    visible_devices: Optional[list] = None
    # admission policy (serve/live_signals.SLOConfig or dict): the proxies
    # shed (429 / RESOURCE_EXHAUSTED + Retry-After) when the route's
    # EWMA-projected wait exceeds slo_s or every replica queue is at
    # max_queue
    slo_config: Optional[Any] = None
    # compiled=True: the proxies serve this deployment over a standing
    # CompiledServeChain (ring channels, lanes spread across replicas,
    # zero control-plane RPCs per warm request) with the dynamic handle
    # kept as the cold-start/failover path. chain_config tunes the chain
    # (lanes, batch_max, coalesce_ms, max_inflight, channel_capacity).
    compiled: bool = False
    chain_config: Optional[Dict[str, Any]] = None

    def bind(self, *args, **kwargs) -> "Deployment":
        return dataclasses.replace(self, init_args=args, init_kwargs=kwargs)

    def options(self, **overrides) -> "Deployment":
        return dataclasses.replace(self, **overrides)

    def to_config(self) -> dict:
        num = self.num_replicas
        auto = self.autoscaling_config
        if isinstance(auto, dict):
            auto = AutoscalingConfig(**auto)
        from ray_tpu_torch.serve.live_signals import as_slo

        slo = as_slo(self.slo_config)
        return {
            "callable": self.func_or_class,
            "num_replicas": num,
            "ray_actor_options": self.ray_actor_options,
            "max_ongoing_requests": self.max_ongoing_requests,
            "user_config": self.user_config,
            "autoscaling_config": auto,
            "init_args": self.init_args,
            "init_kwargs": self.init_kwargs,
            "visible_devices": self.visible_devices,
            "slo_config": slo.to_dict() if slo is not None else None,
            "compiled": bool(self.compiled),
            "chain_config": self.chain_config,
        }


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None, num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               max_ongoing_requests: int = 8,
               user_config: Any = None,
               autoscaling_config: Optional[Any] = None,
               slo_config: Optional[Any] = None,
               compiled: bool = False,
               chain_config: Optional[dict] = None):
    def deco(obj):
        return Deployment(
            func_or_class=obj,
            name=name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            slo_config=slo_config,
            compiled=compiled,
            chain_config=chain_config)

    if _func_or_class is not None:
        return deco(_func_or_class)
    return deco


def _get_or_create_controller():
    from ray_tpu_torch.core.api import _auto_init, get_actor

    _auto_init()
    try:
        return get_actor(CONTROLLER_NAME)
    except ValueError:
        return ServeController.options(
            name=CONTROLLER_NAME, get_if_exists=True, max_concurrency=16,
            num_cpus=0).remote()


def start(http_host: str = "127.0.0.1", http_port: int = 0) -> int:
    """Start the HTTP ingress proxy; returns the bound port (reference
    serve.start(http_options=...))."""
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.ensure_proxy.remote(http_host, http_port),
                       timeout=120)


def _resolve_composition(value, controller):
    """Deployment composition (reference deployment graphs /
    `serve.run(app)` with bound sub-deployments): a Deployment passed as
    an init arg deploys FIRST and arrives at the replica as a
    DeploymentHandle."""
    if isinstance(value, Deployment):
        run(value, _blocking=False)
        return DeploymentHandle(value.name, controller)
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_composition(v, controller)
                           for v in value)
    if isinstance(value, dict):
        return {k: _resolve_composition(v, controller)
                for k, v in value.items()}
    return value


def run(target: Deployment, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        compiled: Optional[bool] = None,
        _blocking: bool = True,
        _local_testing_mode: bool = False):
    """Deploy and return a handle (reference serve.run).

    `compiled=True` marks the deployment for the proxies' compiled
    ingress path (standing ring channels instead of per-request actor
    calls; see serve/compiled_chain.py) — equivalent to
    `@serve.deployment(compiled=True)`, overriding the decorator.

    `_local_testing_mode=True` runs the deployment IN-PROCESS with no
    cluster (reference local_testing_mode): unit-test deployment logic
    without actors/proxies."""
    if compiled is not None:
        target = dataclasses.replace(target, compiled=bool(compiled))
    if _local_testing_mode:
        return LocalDeploymentHandle(
            target if name is None else dataclasses.replace(target,
                                                            name=name))
    controller = _get_or_create_controller()
    # unconditional: _resolve_composition recurses through lists/dicts, so
    # a Deployment nested in e.g. init_args=([dep_a, dep_b],) deploys too
    # (a top-level-only trigger would ship it as a raw dataclass); it's an
    # identity transform when nothing matches
    target = dataclasses.replace(
        target,
        init_args=_resolve_composition(target.init_args, controller),
        init_kwargs=(_resolve_composition(target.init_kwargs, controller)
                     if target.init_kwargs else target.init_kwargs))
    dep_name = name or target.name
    ray_tpu_torch.get(controller.deploy.remote(dep_name, target.to_config()),
                timeout=60)
    if route_prefix is not None:
        ray_tpu_torch.get(controller.set_route.remote(route_prefix, dep_name),
                    timeout=30)
    handle = DeploymentHandle(dep_name, controller)
    if _blocking:
        _wait_healthy(controller, dep_name)
    return handle


def _wait_healthy(controller, dep_name: str, timeout: float = 60):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)
        d = status.get(dep_name)
        if d and d["running"] >= min(d["target"], 1):
            return
        time.sleep(0.1)
    raise TimeoutError(f"deployment {dep_name} did not become ready")


def get_deployment_handle(deployment_name: str) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, _get_or_create_controller())


def status() -> dict:
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)


def delete(deployment_name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(deployment_name),
                timeout=60)


def shutdown() -> None:
    from ray_tpu_torch.core.api import get_actor

    try:
        grpc_proxy = get_actor("serve-grpc-proxy")
    except Exception:
        grpc_proxy = None
    if grpc_proxy is not None:
        try:
            ray_tpu_torch.get(grpc_proxy.stop.remote(), timeout=10)
        except Exception:
            pass
        finally:
            # a detached proxy surviving here would hand later start_grpc()
            # callers a server wired to a dead controller
            try:
                ray_tpu_torch.kill(grpc_proxy)
            except Exception:
                pass
    try:
        controller = get_actor(CONTROLLER_NAME)
    except (ValueError, RuntimeError):
        return
    try:
        ray_tpu_torch.get(controller.shutdown_serve.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


# ------------------------------------------------------ local testing mode
class _LocalResponse:
    """Synchronous stand-in for DeploymentResponse (.result())."""

    def __init__(self, value=None, exc=None):
        self._value, self._exc = value, exc

    def result(self, timeout: Optional[float] = None):
        if self._exc is not None:
            raise self._exc
        return self._value


class _LocalMethod:
    def __init__(self, inst, name: str):
        self._inst, self._name = inst, name

    def remote(self, *args, **kwargs) -> _LocalResponse:
        try:
            return _LocalResponse(getattr(self._inst, self._name)(
                *args, **kwargs))
        except Exception as e:  # surfaced at .result(), like the real path
            return _LocalResponse(exc=e)


class LocalDeploymentHandle:
    """In-process deployment execution — no cluster, no actors
    (reference `serve/_private/local_testing_mode.py`): the user callable
    is constructed HERE and every .remote() runs synchronously. For unit
    tests of deployment logic."""

    def __init__(self, dep: Deployment):
        c = dep.func_or_class
        if isinstance(c, type):
            self._inst = c(*dep.init_args, **(dep.init_kwargs or {}))
        else:
            self._inst = c
        if dep.user_config is not None and hasattr(self._inst,
                                                   "reconfigure"):
            self._inst.reconfigure(dep.user_config)
        self.deployment_name = dep.name

    def remote(self, *args, **kwargs) -> _LocalResponse:
        try:
            return _LocalResponse(self._inst(*args, **kwargs))
        except Exception as e:
            return _LocalResponse(exc=e)

    def options(self, method_name: Optional[str] = None,
                **_ignored) -> Any:
        if method_name:
            return _LocalMethod(self._inst, method_name)
        return self

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _LocalMethod(self._inst, name)
