"""gRPC ingress for Serve deployments (counterpart of
`ray_tpu/serve/grpc_proxy.py`). It imports no torch, and `grpc` only
inside `start`.

grpc's generic RPC handlers, so no protoc codegen is needed: one service
`ray_tpu.serve.ServeAPIService` with method `Call`; request and response
payloads are JSON bytes, and the target application is picked with the
`application` metadata key (the route table's root app by default). An
unknown application aborts NOT_FOUND, a request the route's SLO admission
sheds RESOURCE_EXHAUSTED (with a `retry-after` trailer), a failing call
INTERNAL. The router is the HTTP proxy's, so a compiled deployment's
requests ride its chain here too.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

import ray_tpu_torch

# the wire contract: the JAX package's service name, kept so that one
# client speaks to either package's ingress
SERVICE = "ray_tpu.serve.ServeAPIService"


ROUTE_REFRESH_S = 1.0   # same cadence as the HTTP proxy


class _GrpcServer:
    def __init__(self, controller):
        self._controller = controller
        self._routers = {}
        self._routes = {}
        self._routes_ts = 0.0
        self._server = None

    async def _refresh_routes(self, force: bool = False) -> None:
        now = time.monotonic()
        if force or not self._routes or now - self._routes_ts > ROUTE_REFRESH_S:
            self._routes = await self._controller.get_routes.remote()
            self._routes_ts = now

    async def _route_for(self, app_name: Optional[str]) -> Optional[str]:
        await self._refresh_routes()
        if app_name:
            for _prefix, dep in self._routes.items():
                if dep == app_name:
                    return dep
            await self._refresh_routes(force=True)
            for _prefix, dep in self._routes.items():
                if dep == app_name:
                    return dep
            return None
        if "/" in self._routes:
            return self._routes["/"]
        return next(iter(self._routes.values()), None)

    async def start(self, port: int = 0) -> int:
        import grpc

        from ray_tpu_torch.serve.proxy import Request, _AsyncRouter

        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if not handler_call_details.method.startswith(f"/{SERVICE}/"):
                    return None
                metadata = dict(handler_call_details.invocation_metadata or ())

                async def call(request_bytes, context):
                    from ray_tpu_torch.serve.proxy import (_get_serve_metrics,
                                                     prompt_prefix_key)
                    from ray_tpu_torch.util import tracing

                    try:
                        body = json.loads(request_bytes) if request_bytes else None
                    except json.JSONDecodeError:
                        body = None
                    app = metadata.get("application")
                    dep = await outer._route_for(app)
                    if dep is None:
                        await context.abort(
                            grpc.StatusCode.NOT_FOUND,
                            f"no deployment for application {app!r}")
                    router = outer._routers.get(dep)
                    if router is None:
                        router = outer._routers[dep] = _AsyncRouter(
                            outer._controller, dep)
                    # SLO-aware admission control (HTTP 429's gRPC
                    # sibling): RESOURCE_EXHAUSTED + a retry-after hint
                    # in the trailing metadata
                    try:
                        shed = await router.admission_check()
                    except Exception:
                        shed = None
                    from ray_tpu_torch.serve.proxy import note_admission

                    retry_after = note_admission(f"grpc:{dep}", shed)
                    if shed is not None:
                        context.set_trailing_metadata((
                            ("retry-after", str(retry_after)),))
                        await context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED,
                            f"deployment over capacity "
                            f"({shed['reason']}); retry after "
                            f"{retry_after}s")
                    req = Request("GRPC", handler_call_details.method, {},
                                  metadata, request_bytes, body)
                    model_id = metadata.get("serve_multiplexed_model_id")
                    # root span per RPC, honoring a W3C traceparent riding
                    # the invocation metadata (same contract as HTTP)
                    tp = metadata.get("traceparent")
                    t0 = time.perf_counter()
                    code = "OK"
                    try:
                        with tracing.request_span(
                                "grpc.request",
                                {"traceparent": tp} if tp else None,
                                attributes={"ray_tpu.op": "serve_request",
                                            "rpc.method":
                                                handler_call_details.method,
                                            "rpc.app": dep}):
                            # compiled ingress rides here too (the router
                            # is shared with the HTTP proxy); streaming
                            # bodies stay dynamic — replica-affine
                            stream = bool(isinstance(body, dict)
                                          and body.get("stream"))
                            result = await router.submit(
                                "__call__", (req,), {}, model_id=model_id,
                                prefix_key=prompt_prefix_key(body),
                                allow_compiled=not stream)
                    except Exception as e:  # surface detail like HTTP's 500
                        code = "INTERNAL"
                        await context.abort(grpc.StatusCode.INTERNAL, repr(e))
                    finally:
                        try:
                            _get_serve_metrics()["request_seconds"].observe(
                                time.perf_counter() - t0,
                                tags={"route": f"grpc:{dep}", "code": code})
                        except Exception:
                            pass
                    if isinstance(result, bytes):
                        return result
                    return json.dumps(result, default=str).encode()

                return grpc.unary_unary_rpc_method_handler(
                    call,
                    request_deserializer=None,
                    response_serializer=None)

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((Handler(),))
        bound = self._server.add_insecure_port(f"127.0.0.1:{port}")
        await self._server.start()
        return bound

    async def stop(self):
        loop = asyncio.get_running_loop()
        for router in list(self._routers.values()):
            try:
                await asyncio.wait_for(
                    loop.run_in_executor(None, router.shutdown_chain), 20)
            except Exception:
                pass
        if self._server is not None:
            await self._server.stop(grace=1.0)


@ray_tpu_torch.remote
class GrpcProxyActor:
    """Per-cluster gRPC ingress actor (HTTP proxy's sibling)."""

    def __init__(self, controller_handle):
        self._controller = controller_handle
        self._impl = None
        self._port = None

    async def start(self, port: int = 0) -> int:
        # max_concurrency>1: serialize concurrent start() calls or two
        # servers get created and one leaks
        if not hasattr(self, "_start_lock"):
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            if self._port is None:
                self._impl = _GrpcServer(self._controller)
                self._port = await self._impl.start(port)
        return self._port

    async def ready(self) -> Optional[int]:
        return self._port

    async def stop(self):
        if self._impl is not None:
            await self._impl.stop()


def start_grpc(port: int = 0) -> int:
    """Start (or get) the cluster's gRPC ingress; returns the bound port
    (reference: `serve.start(grpc_options=...)`)."""
    from ray_tpu_torch.serve import api

    controller = api._get_or_create_controller()
    try:
        proxy = ray_tpu_torch.get_actor("serve-grpc-proxy")
    except ValueError:
        proxy = GrpcProxyActor.options(
            name="serve-grpc-proxy", lifetime="detached",
            get_if_exists=True, max_concurrency=64).remote(controller)
    return ray_tpu_torch.get(proxy.start.remote(port), timeout=60)
