"""Worker process entry: executes tasks and hosts actors.

Counterpart of the reference's default_worker.py + task-execution path
(`python/ray/_private/workers/default_worker.py`, `_raylet.pyx:2141
execute_task_with_cancellation_handler`): receives pushed task specs from the
head, runs user code on executor threads, stores results, serves direct
actor calls on its own port. Also implements:

- streaming generators (`num_returns="streaming"`): yields become objects
  reported incrementally with head-enforced backpressure (reference
  `_generator_backpressure_num_objects`, SURVEY §2.12b);
- cancellation: `cancel_task` async-raises TaskCancelledError into the task
  thread (the CPython equivalent of the reference's interrupt path);
- `max_calls`: worker retires after N executions of a task's function;
- async actors: `async def` methods run on the event loop under a
  per-concurrency-group semaphore; sync methods run on per-group thread
  pools (reference fiber/concurrency-group semantics,
  `task_execution/concurrency_group_manager.*`).
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.client import CoreClient
from ray_tpu_torch.core.exceptions import (ObjectLostError, TaskCancelledError,
                                     TaskError)
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.serialization import SerializedObject

DEFAULT_GROUP = "_default"

_EMPTY_ARGS_BLOB: Optional[bytes] = None


def _empty_args_blob() -> bytes:
    """The constant serialized form of ((), {}) — zero-arg calls (the
    actor hot path) ship exactly these bytes (client.py caches the same
    constant), so matching them skips the per-call deserialize."""
    global _EMPTY_ARGS_BLOB
    if _EMPTY_ARGS_BLOB is None:
        _EMPTY_ARGS_BLOB = serialization.serialize(((), {})).to_bytes()
    return _EMPTY_ARGS_BLOB


class WorkerRuntime:
    def __init__(self, head_host: str, head_port: int, session: str):
        self.client = CoreClient(head_host, head_port, session, is_driver=False,
                                 handlers={
                                     "exec_task": self._on_exec_task,
                                     "start_actor": self._on_start_actor,
                                     "cancel_task": self._on_cancel_task,
                                     # liveness probe: answered on the event
                                     # loop, so it proves the PROCESS is
                                     # scheduled (tasks run on executor
                                     # threads) — a SIGSTOP/GIL-wedged
                                     # worker times out (reference
                                     # gcs_health_check_manager.h)
                                     "health_ping": self._on_health_ping,
                                 })
        self.task_executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="task")
        self.actor_executors: Dict[str, ThreadPoolExecutor] = {}
        self.actor_semaphores: Dict[str, asyncio.Semaphore] = {}
        self.actor_method_groups: Dict[str, str] = {}
        self.actor_method_transport: Dict[str, str] = {}
        self.actor_instance = None
        self.actor_id = None
        self.shutdown_event = threading.Event()
        self._task_threads: Dict[bytes, int] = {}    # task_id -> thread ident
        self._fn_calls: Dict[bytes, int] = {}
        self._retiring = False
        self._method_is_coro: Dict[str, bool] = {}   # per-call inspect is hot

    # ------------------------------------------------------------ plumbing
    def start(self):
        # Attach the global API client BEFORE registering with the head:
        # registration makes this worker eligible for task dispatch, and a
        # task using the ray_tpu_torch API (nested .remote/get) must never observe
        # an unset global client.
        import ray_tpu_torch.core.api as api

        api._attach_existing_client(self.client)
        self.client.on_disconnect = lambda: self.shutdown_event.set()
        self.client.on_registered = self._apply_sys_path
        self.client.start(direct_handlers={
            "actor_call": self._on_actor_call,
            "lease_exec": self._on_lease_exec,
        })
        if "driver_sys_path" not in (self.client.node_info or {}):
            self._extend_sys_path()

    @staticmethod
    def _adopt_sys_path(blob) -> None:
        import json

        if not blob:
            return
        try:
            for p in json.loads(blob):
                if p not in sys.path and os.path.isdir(p):
                    sys.path.append(p)
        except Exception:
            pass

    def _apply_sys_path(self, node_info: dict) -> None:
        """Adopt the driver's import roots before any task can be dispatched
        to us (same-machine runtime-env lite); the head ships them in the
        registration ack."""
        self._adopt_sys_path(node_info.get("driver_sys_path"))

    def _extend_sys_path(self):
        """Fallback for workers registered before any driver connected."""
        try:
            self._adopt_sys_path(self.client.kv_get("cluster", b"driver_sys_path"))
        except Exception:
            pass

    def _adopt_dep_metas(self, spec) -> None:
        """Dep metas shipped with a task spec (lease push or head
        dispatch of data-stage tasks): adopt them so argument resolution
        pulls straight through the node PullManager instead of paying a
        get_meta round trip per dependency. A meta we already hold wins
        (it may be a fresher pulled copy); a stale shipped meta falls
        back to locate_object inside the pull path."""
        for m in spec.get("dep_metas") or ():
            self.client.local_metas.setdefault(m.object_id, m)

    def _resolve_args(self, payload) -> tuple:
        if "inline" in payload:
            if payload["inline"] == _empty_args_blob():
                return (), {}
            ser = SerializedObject.from_view(memoryview(payload["inline"]))
        else:
            meta = payload["meta"]
            self.client.local_metas[meta.object_id] = meta
            ser = self.client.read_serialized(meta)  # pulls if cross-node
        args, kwargs = serialization.deserialize(ser)
        args = [self.client.get([a])[0] if isinstance(a, ObjectRef) else a
                for a in args]
        kwargs = {k: (self.client.get([v])[0] if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        return args, kwargs

    async def _resolve_args_async(self, payload) -> tuple:
        """Event-loop-safe variant (async actor methods run on the loop; the
        sync path would deadlock calling back into it)."""
        if "inline" in payload:
            if payload["inline"] == _empty_args_blob():
                return (), {}
            ser = SerializedObject.from_view(memoryview(payload["inline"]))
        else:
            meta = payload["meta"]
            self.client.local_metas[meta.object_id] = meta
            ser = await self.client.read_serialized_async(meta)
        args, kwargs = serialization.deserialize(ser)
        out_args = []
        for a in args:
            out_args.append(await self.client.get_async([a])
                            if isinstance(a, ObjectRef) else a)
        out_kwargs = {}
        for k, v in kwargs.items():
            out_kwargs[k] = (await self.client.get_async([v])
                             if isinstance(v, ObjectRef) else v)
        return tuple(out_args), out_kwargs

    # -------------------------------------------------------------- tasks
    async def _on_exec_task(self, spec):
        loop = asyncio.get_running_loop()
        loop.run_in_executor(self.task_executor, self._run_task, spec)
        return True

    async def _on_lease_exec(self, spec):
        """Direct task push from a lease-holding client (reference
        PushNormalTask, `normal_task_submitter.cc:515`): executes on the
        task thread and replies with the result meta — the head is not on
        this path at all."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self.task_executor,
                                          self._run_lease_task, spec)

    def _run_lease_task(self, spec):
        rid = ObjectID(spec["return_ids"][0])
        opts = spec.get("options", {})
        task_key = spec["task_id"].binary()
        self._task_threads[task_key] = threading.get_ident()
        # run-phase timing for the submitter's flight recorder: the head
        # never sees lease-path tasks, so the execution window rides the
        # reply (only when the driver traces — the carrier's presence).
        # Opened AFTER function load + argument resolution so dependency
        # fetches land in the dispatch phase, not in "run".
        prof = None
        try:
            from ray_tpu_torch.util import tracing

            fn = self.client.fn_manager.load(spec["fn_key"],
                                 blob=spec.get("fn_blob"))
            self._adopt_dep_metas(spec)
            # dependency fetches land in the dispatch phase (outside the
            # run span) but still carry the task's trace context, so
            # object-pull spans parent to the submitting trace
            with tracing.adopt_context(opts.get("trace_ctx")):
                args, kwargs = self._resolve_args(spec["args"])
            if opts.get("trace_ctx"):
                prof = {"start": time.time()}
            with tracing.execute_span(opts.get("name", "task"),
                                      opts.get("trace_ctx")):
                result = fn(*args, **kwargs)
            if prof is not None:
                prof["end"] = time.time()
            meta = self.client.store_result(rid, result, register=False)
        except BaseException as e:  # noqa: BLE001 - failures become error objects
            # ObjectLostError passes unwrapped (retryable input loss)
            err = e if isinstance(
                e, (TaskError, TaskCancelledError, ObjectLostError)) else \
                TaskError(repr(e), traceback.format_exc())
            meta = self.client.store_result(rid, err, register=False,
                                            is_error=True)
        finally:
            self._task_threads.pop(task_key, None)
            max_calls = opts.get("max_calls")
            if max_calls:
                fn_key = spec["fn_key"]
                self._fn_calls[fn_key] = self._fn_calls.get(fn_key, 0) + 1
                if self._fn_calls[fn_key] >= max_calls:
                    self._retiring = True
                    try:
                        self.client.head_push("worker_retiring")
                    except Exception:
                        pass
        rep = {"meta": meta, "retired": self._retiring}
        if prof is not None:
            prof.setdefault("end", time.time())  # error path: fn raised
            rep["prof"] = prof
        return rep

    async def _on_health_ping(self):
        return True

    async def _on_cancel_task(self, task_id):
        ident = self._task_threads.get(task_id)
        if ident is not None:
            # CPython async-raise into the task thread: the closest
            # single-process analog of the reference's cancellation interrupt
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError))
        return ident is not None

    def _run_task(self, spec):
        return_ids = [ObjectID(b) for b in spec["return_ids"]]
        opts = spec.get("options", {})
        task_key = spec["task_id"].binary()
        self._task_threads[task_key] = threading.get_ident()
        streaming = opts.get("num_returns") == "streaming"
        applied = None
        try:
            if opts.get("runtime_env"):
                from ray_tpu_torch.core.runtime_env import AppliedEnv

                applied = AppliedEnv(self.client, opts["runtime_env"])
            from ray_tpu_torch.util import tracing

            fn = self.client.fn_manager.load(spec["fn_key"],
                                 blob=spec.get("fn_blob"))
            self._adopt_dep_metas(spec)
            with tracing.adopt_context(opts.get("trace_ctx")):
                args, kwargs = self._resolve_args(spec["args"])
            with tracing.execute_span(opts.get("name", "task"),
                                      opts.get("trace_ctx")):
                result = fn(*args, **kwargs)
                if streaming:
                    # generators do their real work during the drain — the
                    # span must cover it, not just the immediate call
                    self._drain_generator(return_ids[0], result, opts)
                else:
                    results = ([result] if len(return_ids) == 1
                               else list(result))
                    if len(results) != len(return_ids):
                        raise ValueError(
                            f"task returned {len(results)} values, "
                            f"expected {len(return_ids)}")
                    for rid, val in zip(return_ids, results):
                        self.client.store_result(rid, val, register=True)
        except BaseException as e:  # noqa: BLE001 - all failures become error objects
            err = e if isinstance(e, TaskError) else TaskError(
                repr(e), traceback.format_exc())
            if isinstance(e, (TaskCancelledError, ObjectLostError)):
                # ObjectLostError stays unwrapped: a consumer whose INPUT
                # went lost (vs. its own code failing) is retryable by
                # the submitting executor once the input reconstructs
                err = e
            for rid in return_ids:
                try:
                    self.client.store_result(rid, err, register=True, is_error=True)
                except Exception:
                    pass
        finally:
            if applied is not None:
                applied.restore()
            self._task_threads.pop(task_key, None)
            retire = False
            max_calls = opts.get("max_calls")
            if max_calls:
                fn_key = spec["fn_key"]
                self._fn_calls[fn_key] = self._fn_calls.get(fn_key, 0) + 1
                retire = self._fn_calls[fn_key] >= max_calls
            try:
                if retire:
                    self.client.head_push("worker_retiring")
                # push: the completion signal needs no reply, and a blocking
                # round trip here caps pipelined task throughput
                self.client.head_push("task_done",
                                      task_id=spec["task_id"].binary())
            except Exception:
                pass
            if retire:
                self._retiring = True
                self.shutdown_event.set()

    def _drain_generator(self, gen_id: ObjectID, result, opts) -> None:
        """Stream yielded values to the head as they materialize."""
        backpressure = opts.get("_generator_backpressure_num_objects") or 0
        count = 0
        for item in result:
            oid = ObjectID.generate()
            # via_head: generator_yield seals this meta at the head itself
            meta = self.client.store_result(oid, item, register=False,
                                            via_head=True)
            # the head seals the meta; the reply is delayed for backpressure
            self.client.head_request("generator_yield", gen_id=gen_id.binary(),
                                     meta=meta, backpressure=backpressure)
            count += 1
        self.client.head_request("generator_done", gen_id=gen_id.binary())

    # ------------------------------------------------------------- actors
    async def _on_start_actor(self, spec):
        loop = asyncio.get_running_loop()
        opts = spec["options"]
        max_conc = opts.get("max_concurrency", 1)
        groups = dict(opts.get("concurrency_groups") or {})
        self.actor_executors = {
            DEFAULT_GROUP: ThreadPoolExecutor(max_conc,
                                              thread_name_prefix="actor")}
        self.actor_semaphores = {DEFAULT_GROUP: asyncio.Semaphore(max_conc)}
        for gname, n in groups.items():
            self.actor_executors[gname] = ThreadPoolExecutor(
                int(n), thread_name_prefix=f"actor-{gname}")
            self.actor_semaphores[gname] = asyncio.Semaphore(int(n))
        self.actor_method_groups = {
            m: meta.get("concurrency_group") for m, meta in
            spec.get("methods", {}).items() if meta.get("concurrency_group")}
        self.actor_method_transport = {
            m: meta.get("tensor_transport") for m, meta in
            spec.get("methods", {}).items() if meta.get("tensor_transport")}
        self.actor_id = ActorID(spec["actor_id"])
        self.client.current_actor_id = self.actor_id

        def _init():
            if opts.get("runtime_env"):
                from ray_tpu_torch.core.runtime_env import AppliedEnv

                # actors keep their env for life (dedicated-worker model);
                # never restored — the worker exits with the actor
                AppliedEnv(self.client, opts["runtime_env"])
            cls = self.client.fn_manager.load(spec["cls_key"])
            args, kwargs = self._resolve_args(spec["args"])
            self.actor_instance = cls(*args, **kwargs)

        try:
            await loop.run_in_executor(self.actor_executors[DEFAULT_GROUP], _init)
            await self.client.conn.request(
                "actor_ready", actor_id=spec["actor_id"],
                address=("127.0.0.1", self.client.direct_port))
        except Exception:
            try:
                await self.client.conn.request(
                    "actor_creation_failed", actor_id=spec["actor_id"],
                    cause=traceback.format_exc())
            except Exception:
                pass
        return True

    async def _on_actor_call(self, actor_id, method, args, deps, return_id,
                             group=None, trace=None):
        loop = asyncio.get_running_loop()
        rid = ObjectID(return_id)
        gname = group or self.actor_method_groups.get(method) or DEFAULT_GROUP
        fn = getattr(self.actor_instance, method, None)
        from ray_tpu_torch.util import tracing

        span_name = f"{type(self.actor_instance).__name__}.{method}"

        is_coro = self._method_is_coro.get(method)
        if is_coro is None:
            is_coro = self._method_is_coro[method] = (
                fn is not None and inspect.iscoroutinefunction(fn))
        if is_coro:
            # async actor method: runs on this event loop under the group's
            # semaphore (reference asyncio-actor / fiber semantics)
            sem = self.actor_semaphores.get(gname) or \
                self.actor_semaphores[DEFAULT_GROUP]
            async with sem:
                try:
                    with tracing.execute_span(span_name, trace):
                        a, kw = await self._resolve_args_async(args)
                        result = await fn(*a, **kw)
                    if self.actor_method_transport.get(method) == "device":
                        meta = self.client.store_device_result(rid, result)
                    else:
                        meta = self.client.store_result(rid, result,
                                                        register=False)
                except BaseException as e:  # noqa: BLE001
                    err = e if isinstance(e, TaskError) else TaskError(
                        repr(e), traceback.format_exc())
                    meta = self.client.store_result(rid, err, register=False,
                                                    is_error=True)
            return {"meta": meta}

        def _run():
            try:
                if method == "__rtpu_dag_exec_loop__":
                    # injected compiled-DAG loop (reference __ray_call__ +
                    # do_exec_tasks): runs against the hosted instance
                    import functools

                    from ray_tpu_torch.dag.runtime import exec_dag_loop

                    f = functools.partial(exec_dag_loop, self.actor_instance)
                else:
                    f = getattr(self.actor_instance, method)
                with tracing.execute_span(span_name, trace):
                    a, kw = self._resolve_args(args)
                    result = f(*a, **kw)
                if self.actor_method_transport.get(method) == "device":
                    # result stays on-device in this process; only the
                    # meta rides the reply (RDT tensor_transport)
                    return self.client.store_device_result(rid, result)
                return self.client.store_result(rid, result, register=False)
            except BaseException as e:  # noqa: BLE001
                err = e if isinstance(e, TaskError) else TaskError(
                    repr(e), traceback.format_exc())
                return self.client.store_result(rid, err, register=False,
                                                is_error=True)

        executor = self.actor_executors.get(gname) or \
            self.actor_executors[DEFAULT_GROUP]
        meta = await loop.run_in_executor(executor, _run)
        return {"meta": meta}

    # ---------------------------------------------------------------- run
    def run_forever(self):
        self.shutdown_event.wait()
        self.client.shutdown()


def main():
    from ray_tpu_torch.core import config as _config

    head_host = _config.get("head_host")
    head_port = int(os.environ["RAY_TPU_HEAD_PORT"])
    session = os.environ["RAY_TPU_SESSION"]
    rt = WorkerRuntime(head_host, head_port, session)
    try:
        rt.start()
    except (ConnectionRefusedError, OSError, TimeoutError):
        sys.exit(0)  # head already gone: racing a cluster shutdown
    rt.run_forever()


if __name__ == "__main__":
    main()
