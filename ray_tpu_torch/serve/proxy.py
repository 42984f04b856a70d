"""HTTP ingress proxy actor (aiohttp) + async client-side router; the
counterpart of `ray_tpu/serve/proxy.py`. It imports no torch.

Parity with the reference's per-node proxy actors
(`python/ray/serve/_private/proxy.py`, starlette/uvicorn) re-based on
aiohttp: the proxy polls the controller for the route table (long-poll-lite,
`long_poll.py` role), matches the longest route prefix, routes to a
replica, and awaits the reply on the event loop — requests never block the
loop thread.

Serving-plane additions: the router's pow-2 choice compares LIVE load
(gossiped queue depth / EWMA latency from `state.list_serve_stats()`,
blended with local in-flight counts — see serve/live_signals.py) with
prompt-prefix affinity kept as the tiebreak; the proxy runs SLO-aware
admission control per route (429 + Retry-After when the projected wait
exceeds the route's SLO or every replica's queue is at its bound), and
failed submissions to a dying replica fail over to a healthy one instead
of surfacing a 500.

The compiled ingress (a deployment marked `compiled=True`, served over a
standing CompiledServeChain) is ROADMAP item 18b: until it is ported,
such a deployment's requests answer 500 with the NotImplementedError that
names it.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import live_signals

ROUTE_REFRESH_S = 1.0
SUBMIT_ATTEMPTS = 3     # original try + failovers on replica death

# ------------------------------------------------------- serve telemetry
_serve_metrics = None


def _get_serve_metrics():
    """Lazy per-process serve metrics (proxy + gRPC ingress share them);
    they ride the ordinary metrics pusher to the head's /metrics."""
    global _serve_metrics
    if _serve_metrics is None:
        from ray_tpu_torch.util import metrics as m

        _serve_metrics = {
            "request_seconds": m.Histogram(
                "serve_request_seconds",
                "Ingress request latency by matched route and status code",
                tag_keys=("route", "code")),
            "admitted": m.Counter(
                "serve_admitted_total",
                "Ingress requests admitted past the route's admission "
                "policy", tag_keys=("route",)),
            "shed": m.Counter(
                "serve_shed_total",
                "Ingress requests shed by SLO-aware admission control "
                "(HTTP 429 / gRPC RESOURCE_EXHAUSTED)",
                tag_keys=("route", "reason")),
            "failover": m.Counter(
                "serve_failover_total",
                "Requests re-routed to another replica after an "
                "infrastructure failure (replica death/drain)",
                tag_keys=("route",)),
        }
    return _serve_metrics


def note_admission(route: str, shed: Optional[dict]) -> Optional[int]:
    """Count one admission decision (shared by the HTTP and gRPC
    ingresses so the counters and the Retry-After formatting can't
    drift); for a shed, returns the Retry-After hint in whole seconds
    (ceiling, >= 1)."""
    try:
        m = _get_serve_metrics()
        if shed is not None:
            m["shed"].inc(tags={"route": route, "reason": shed["reason"]})
        else:
            m["admitted"].inc(tags={"route": route})
    except Exception:
        pass
    if shed is None:
        return None
    return max(1, int(-(-float(shed["retry_after_s"]) // 1)))


def _is_infra_error(e: BaseException) -> bool:
    """Failures that justify re-routing to ANOTHER replica: the replica
    died, drained, or its connection dropped. User exceptions raised
    inside the deployment are NOT retried — they would re-run user code
    for a deterministic failure.

    NOTE: this gives ingress requests at-least-once semantics under
    replica death — a handler that ran to completion just before its
    process died may run again elsewhere. That matches the actor layer's
    own lost-reply resend contract (client._fast_actor_send) and the
    usual serving tradeoff: handlers observable from outside should be
    idempotent per request."""
    from ray_tpu_torch.core import protocol
    from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                         ActorUnavailableError,
                                         WorkerCrashedError)

    if isinstance(e, (ActorDiedError, ActorUnavailableError,
                      WorkerCrashedError, protocol.ConnectionLost,
                      ConnectionRefusedError)):
        return True
    if isinstance(e, RuntimeError):
        msg = str(e)
        return "draining" in msg or "is gone" in msg
    return False


class Request:
    """What a deployment callable receives for an HTTP request."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes, json: Any):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.json = json

    def __getitem__(self, key):  # dict-style access to the json body
        return (self.json or {})[key]

    def get(self, key, default=None):
        return (self.json or {}).get(key, default)

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query, self.headers,
                          self.body, self.json))


PREFIX_MAP_CAP = 2048       # remembered prompt-prefix -> replica pairs
PREFIX_IMBALANCE_SLACK = 4  # cache affinity yields when this much busier


def prompt_prefix_key(json_body) -> Optional[str]:
    """Stable key for the prompt prefix of an LLM-shaped request body
    (reference prefix_aware_router.py:39 — route requests sharing a
    prefix to the replica whose KV cache already holds it)."""
    if not isinstance(json_body, dict):
        return None
    text = None
    if isinstance(json_body.get("prompt"), str):
        text = json_body["prompt"]
    elif isinstance(json_body.get("messages"), list):
        try:
            text = "".join(str(m.get("content", ""))
                           for m in json_body["messages"])
        except AttributeError:
            return None
    if not text:
        return None
    import hashlib

    return hashlib.blake2b(text[:256].encode(), digest_size=8).hexdigest()


class _AsyncRouter:
    """Live-load replica choice (pow-2 on gossiped queue depth blended
    with local in-flight counts), all-async; prompt-prefix affinity as
    the tiebreak; per-route SLO admission; failover on replica death."""

    def __init__(self, controller, deployment: str):
        self._controller = controller
        self._deployment = deployment
        self._table: Dict[str, Any] = {}
        self._model_map: Dict[str, list] = {}
        self._slo: Optional[dict] = None
        self._ts = 0.0
        self._inflight: Dict[str, int] = {}
        self._compiled = False       # set from the routing table
        # requests queued behind a scaled-to-zero deployment; pushed to
        # the controller as the wake-up demand signal
        self._cold_waiters = 0
        from collections import OrderedDict

        self._prefix_map: "OrderedDict[str, str]" = OrderedDict()

    async def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._ts < ROUTE_REFRESH_S:
            return
        ref = self._controller.get_routing_table.remote(self._deployment)
        table = await ref
        if table:
            self._table = table["replicas"]
            self._model_map = table.get("models", {})
            self._slo = table.get("slo")
            self._compiled = bool(table.get("compiled"))
            self._inflight = {t: self._inflight.get(t, 0)
                              for t in self._table}
            # a dead replica's stale prefix mapping would eat a failed
            # first route before the pow-2 fallback: evict entries whose
            # replica left the route table
            for key in [k for k, tag in self._prefix_map.items()
                        if tag not in self._table]:
                del self._prefix_map[key]
            if self._compiled:
                self._maybe_start_chain()
        self._ts = now

    def _maybe_start_chain(self) -> None:
        """The JAX package stands up the deployment's compiled ingress
        chain here (CompiledServeChain over ring channels). That chain is
        ROADMAP item 18b, not ported yet: a deployment marked compiled is
        refused rather than served by a path it did not ask for."""
        raise NotImplementedError(
            f"deployment {self._deployment!r} is marked compiled=True: the "
            f"compiled serve chain is ROADMAP item 18b, not ported to "
            f"ray_tpu_torch yet")

    def _live_cache(self):
        # lazy: unit tests build routers via __new__ with hand-set state
        live = getattr(self, "_live", None)
        if live is None:
            live = self._live = live_signals.get_cache()
        return live

    def _drop_replica(self, tag: str) -> None:
        """Stop routing to a replica this process just watched fail; the
        next table refresh re-adds it only if the controller still
        believes in it."""
        self._table.pop(tag, None)
        for key in [k for k, t in self._prefix_map.items() if t == tag]:
            del self._prefix_map[key]

    def _score(self, tag: str, now: float, max_age_s: float) -> float:
        return live_signals.replica_score(
            self._inflight.get(tag, 0),
            self._live_cache().row(self._deployment, tag), now, max_age_s)

    def _choose(self, tags, prefix_key: Optional[str]) -> str:
        now = time.time()
        max_age = live_signals._flag("serve_live_signal_max_age_s", 5.0)
        if prefix_key is not None and len(tags) > 1:
            # cache affinity: a replica that served this prefix holds its
            # KV blocks — prefer it unless clearly busier than the rest
            # (reference PrefixAwareRequestRouter's imbalance threshold)
            mapped = self._prefix_map.get(prefix_key)
            if mapped in self._table and mapped in tags:
                floor = min(self._score(t, now, max_age) for t in tags)
                if (self._score(mapped, now, max_age)
                        <= floor + PREFIX_IMBALANCE_SLACK):
                    self._prefix_map.move_to_end(prefix_key)
                    return mapped
        live = self._live_cache()
        tag = live_signals.pick_pow2(
            tags,
            lambda t: self._score(t, now, max_age),
            lambda t: live_signals.ewma_of(live.row(self._deployment, t)))
        if prefix_key is not None:
            self._prefix_map[prefix_key] = tag
            self._prefix_map.move_to_end(prefix_key)
            while len(self._prefix_map) > PREFIX_MAP_CAP:
                self._prefix_map.popitem(last=False)
        return tag

    async def admission_check(self) -> Optional[dict]:
        """None to admit; a shed dict ({"reason", "retry_after_s",
        "projected_wait_s"}) to reject before touching a replica."""
        await self._refresh()
        slo = getattr(self, "_slo", None)
        if not slo or not self._table:
            return None
        live = self._live_cache()
        await live.refresh_async()
        now = time.time()
        replicas = [(self._inflight.get(t, 0),
                     live.row(self._deployment, t))
                    for t in self._table]
        return live_signals.admission_decision(slo, replicas, now)

    async def submit(self, method: str, args: tuple, kwargs: dict,
                     model_id: Optional[str] = None,
                     with_tag: bool = False,
                     prefix_key: Optional[str] = None):
        await self._refresh()
        await self._live_cache().refresh_async()
        # Cold-start path (scale-to-zero): a deployment parked at zero
        # replicas has an empty route table. Queue here — NOT 500 — and
        # push our queue depth to the controller as demand (~1/s): that is
        # the live signal `calculate_desired_num_replicas` wakes on. The
        # deadline covers a replica __init__ (checkpoint/P2P weight load),
        # aligned with the controller's REPLICA_INIT_GRACE_S.
        if not self._table:
            deadline = time.monotonic() + live_signals._flag(
                "serve_cold_start_deadline_s", 120.0)
            self._cold_waiters = getattr(self, "_cold_waiters", 0) + 1
            last_push = 0.0
            try:
                while not self._table:
                    now = time.monotonic()
                    if now > deadline:
                        raise RuntimeError(
                            f"no replicas for {self._deployment}")
                    if now - last_push >= 1.0:
                        last_push = now
                        try:
                            await self._controller.record_handle_metrics \
                                .remote(self._deployment, self._cold_waiters)
                        except Exception:
                            pass    # controller restarting: keep queueing
                    await asyncio.sleep(0.1)
                    await self._refresh(force=True)
            finally:
                self._cold_waiters -= 1
        if model_id:
            kwargs = {**kwargs, "_multiplexed_model_id": model_id}
        excluded: set = set()
        last_err: Optional[BaseException] = None
        for attempt in range(SUBMIT_ATTEMPTS):
            tags = [t for t in self._table if t not in excluded]
            if model_id:
                warm = [t for t in tags
                        if model_id in self._model_map.get(t, [])]
                if warm:
                    tags = warm
            if not tags:
                break
            tag = self._choose(tags, prefix_key)
            try:
                result = await self.submit_on(tag, method, args, kwargs)
                return (result, tag) if with_tag else result
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_infra_error(e) or attempt == SUBMIT_ATTEMPTS - 1:
                    raise
                # replica died/drained mid-request: fail over to another
                # replica instead of surfacing a 500 for an operation the
                # replica never completed
                last_err = e
                excluded.add(tag)
                self._drop_replica(tag)
                try:
                    _get_serve_metrics()["failover"].inc(
                        tags={"route": self._deployment})
                except Exception:
                    pass
                await self._refresh(force=True)
        raise last_err or RuntimeError(
            f"no live replicas for {self._deployment}")

    async def submit_on(self, tag: str, method: str, args: tuple,
                        kwargs: dict):
        """Call a SPECIFIC replica — SSE streams must pull follow-up
        chunks from the replica that owns the stream state."""
        handle = self._table.get(tag)
        if handle is None:
            raise RuntimeError(f"replica {tag} is gone")
        self._inflight[tag] = self._inflight.get(tag, 0) + 1
        try:
            # .remote() can block on the head for large payloads (object
            # registration); keep it off the event loop. The contextvars
            # copy carries the request's root span into the executor
            # thread, where call_actor injects it toward the replica.
            import contextvars

            loop = asyncio.get_running_loop()
            ctx = contextvars.copy_context()
            ref = await loop.run_in_executor(
                None, lambda: ctx.run(
                    lambda: handle.handle_request.remote(
                        method, args, kwargs)))
            return await ref
        finally:
            self._inflight[tag] = max(0, self._inflight.get(tag, 1) - 1)


@ray_tpu_torch.remote
class ProxyActor:
    """Per-node HTTP ingress. Async actor: aiohttp server on the event loop.

    The controller HANDLE is passed in (never looked up here): proxy code
    runs on the worker's event loop, where blocking client calls would
    deadlock — everything control-plane is awaited.
    """

    def __init__(self, controller_handle):
        self._controller = controller_handle
        self._routes: Dict[str, str] = {}
        self._routers: Dict[str, _AsyncRouter] = {}
        self._routes_ts = 0.0
        self._runner = None
        self.port: Optional[int] = None

    def _get_controller(self):
        return self._controller

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self.port

    async def _refresh_routes(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._routes_ts < ROUTE_REFRESH_S:
            return
        self._routes = await self._get_controller().get_routes.remote()
        self._routes_ts = now

    async def _handle(self, request):
        """Telemetry wrapper: one root span per request (honoring an
        incoming W3C `traceparent`, so a client-supplied trace id follows
        the request into the replica) + `serve_request_seconds` by
        matched route and status code."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        tp = request.headers.get("traceparent")
        with tracing.request_span(
                "http.request",
                {"traceparent": tp} if tp else None,
                attributes={"ray_tpu.op": "serve_request",
                            "http.method": request.method,
                            "http.path": "/" + request.match_info["tail"]}
                ) as span:
            resp = await self._handle_routed(request)
            if span is not None:
                span.attributes["http.status"] = resp.status
        route = request.get("rtpu_route") or "(no_route)"
        try:
            _get_serve_metrics()["request_seconds"].observe(
                time.perf_counter() - t0,
                tags={"route": route, "code": str(resp.status)})
        except Exception:
            pass
        return resp

    async def _handle_routed(self, request):
        from aiohttp import web

        await self._refresh_routes()
        path = "/" + request.match_info["tail"]
        match = None
        for prefix in sorted(self._routes, key=len, reverse=True):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") \
                    or prefix == "/":
                match = prefix
                break
        if match is None:
            await self._refresh_routes(force=True)
            for prefix in sorted(self._routes, key=len, reverse=True):
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    match = prefix
                    break
        if match is None:
            return web.json_response({"error": f"no route for {path}"},
                                     status=404)
        request["rtpu_route"] = match
        deployment = self._routes[match]
        router = self._routers.get(deployment)
        if router is None:
            router = self._routers[deployment] = _AsyncRouter(
                self._get_controller(), deployment)
        # SLO-aware admission control: shed BEFORE reading the body into
        # a replica call — an overloaded route answers 429 + Retry-After
        # from the proxy alone (reference: Serve's backpressure returns
        # 503; 429 matches the retryable-client contract here)
        try:
            shed = await router.admission_check()
        except Exception:
            shed = None     # a broken signal plane must not block ingress
        retry_after = note_admission(match, shed)
        if shed is not None:
            return web.json_response(
                {"error": "deployment over capacity",
                 "reason": shed["reason"],
                 "projected_wait_s": shed.get("projected_wait_s")},
                status=429, headers={"Retry-After": str(retry_after)})
        body = await request.read()
        try:
            json_body = await request.json() if body else None
        except Exception:
            json_body = None
        req = Request(request.method, path, dict(request.query),
                      dict(request.headers), body, json_body)
        model_id = request.headers.get("serve_multiplexed_model_id")
        try:
            result, tag = await router.submit(
                "__call__", (req,), {}, model_id=model_id, with_tag=True,
                prefix_key=prompt_prefix_key(json_body))
        except Exception as e:  # noqa: BLE001 - surface as HTTP 500
            return web.json_response({"error": repr(e)}, status=500)
        if isinstance(result, dict) and "__sse_stream__" in result:
            # streams are replica-affine: the follow-up stream_next calls
            # go to the replica (tag) that holds the stream
            return await self._stream_sse(request, router, tag,
                                          result["__sse_stream__"])
        if isinstance(result, web.Response):
            return result
        if isinstance(result, (dict, list)):
            return web.json_response(result)
        if isinstance(result, bytes):
            return web.Response(body=result)
        return web.Response(text=str(result))

    async def _stream_sse(self, request, router: _AsyncRouter, tag: str,
                          info: dict):
        """OpenAI `stream: true` transport: pull incremental tokens from
        the owning replica and relay them as server-sent events, ending
        with `data: [DONE]` (reference serve.llm streaming router)."""
        import json as _json

        from aiohttp import web

        import uuid

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive"})
        await resp.prepare(request)
        sid = info["stream_id"]
        chat = info.get("mode") == "chat"
        created = int(time.time())
        # one id for every chunk of the stream (OpenAI SDKs require it)
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        cursor = 0
        last_progress = time.monotonic()
        try:
            while True:
                chunk = await router.submit_on(
                    tag, "stream_next", (sid,), {"cursor": cursor})
                if chunk.get("error"):
                    await resp.write(
                        f"data: {_json.dumps({'error': chunk['error']})}"
                        f"\n\n".encode())
                    await resp.write(b"data: [DONE]\n\n")
                    break
                cursor = chunk.get("cursor", cursor)
                done = chunk.get("done", False)
                if not chunk["token_ids"] and not done:
                    # queued behind a full slot batch: bounded patience,
                    # then a clean error instead of an immortal stream
                    if time.monotonic() - last_progress > 120:
                        await resp.write(
                            b'data: {"error": "generation stalled"}\n\n'
                            b"data: [DONE]\n\n")
                        break
                    continue
                last_progress = time.monotonic()
                # chunk["text"] is the server-computed DELTA (derived from
                # a cumulative decode, so multi-byte chars never split)
                delta_text = chunk["text"]
                if not delta_text and not done:
                    # tokens arrived but decoded to nothing yet (the
                    # server holds back a partial multi-byte char): the
                    # text rides the next decodable delta, so emitting an
                    # empty chunk here is pure noise — and makes the
                    # first-chunk-has-content property timing-dependent
                    continue
                finish = chunk.get("finish_reason") if done else None
                if chat:
                    payload = {
                        "id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": info["model"],
                        "choices": [{"index": 0,
                                     "delta": ({"content": delta_text}
                                               if delta_text else {}),
                                     "finish_reason": finish}]}
                else:
                    payload = {
                        "id": rid, "object": "text_completion",
                        "created": created, "model": info["model"],
                        "choices": [{"index": 0, "text": delta_text,
                                     "finish_reason": finish}]}
                await resp.write(
                    f"data: {_json.dumps(payload)}\n\n".encode())
                if done:
                    await resp.write(b"data: [DONE]\n\n")
                    break
        except (ConnectionResetError, asyncio.CancelledError):
            pass  # client went away; the replica GC's the stream by TTL
        except Exception as e:  # noqa: BLE001 - headers already sent:
            # the failure must arrive as an SSE event, not a TCP reset
            # (replica restarted mid-stream, stream id lost, ...)
            try:
                await resp.write(
                    f"data: {_json.dumps({'error': repr(e)})}\n\n"
                    f"data: [DONE]\n\n".encode())
            except Exception:
                pass
        await resp.write_eof()
        return resp

    async def ready(self) -> int:
        return self.port

    # ------------------------------------------------------- test support
    async def rpc_audit_start(self) -> bool:
        """Head-RPC audit between start/stop, recorded INSIDE the proxy
        process (the zero-control-plane-RPCs-per-warm-request contract is
        interposer-verified where the ingress actually runs)."""
        if not hasattr(self, "_audit"):
            from ray_tpu_torch.serve.disagg import _RpcAudit

            self._audit = _RpcAudit()
        return self._audit.start()

    async def rpc_audit_stop(self) -> list:
        if not hasattr(self, "_audit"):
            return []
        return self._audit.stop()

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
        return True
