"""Public task/actor API: init, @remote, get/put/wait, actors, kill.

Counterpart of `ray_tpu/core/api.py`, with GPUs (`num_gpus`, resource
"GPU") where the JAX package counts TPU chips (`num_tpu_chips`, "TPU").
The head and its workers run this package's `core.head_main` and
`core.worker_main`; `init("ray-tpu://host:port")` drives a cluster
through its head's client proxy. `put_device` keeps a CUDA tensor in its
process's device store (`core/device_store.py`). What waits for later parts
of the port raises NotImplementedError naming its ROADMAP item: DAGs
(`.bind`, item 17).
"""

from __future__ import annotations

import atexit
import functools
import json
import os
from ray_tpu_torch.core import config as _config
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.core.client import CoreClient
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef

_client: Optional[CoreClient] = None
_head_proc: Optional[subprocess.Popen] = None
_lock = threading.RLock()

DEFAULT_TASK_OPTIONS = {
    "num_cpus": 1.0, "num_gpus": 0, "resources": None, "max_retries": 3,
    "num_returns": 1, "name": None, "placement_group": None,
}
DEFAULT_ACTOR_OPTIONS = {
    "num_cpus": 0.0, "num_gpus": 0, "resources": None, "max_restarts": 0,
    "max_concurrency": 1, "name": None, "namespace": "default",
    "lifetime": None, "get_if_exists": False, "placement_group": None,
}


def _global_client() -> CoreClient:
    if _client is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _client


def _attach_existing_client(client: CoreClient) -> None:
    """Used by worker processes so user code can call the API inside tasks."""
    global _client
    _client = client


def is_initialized() -> bool:
    return _client is not None


def init(address: Optional[str] = None, *, num_cpus: Optional[float] = None,
         num_gpus: Optional[int] = None, resources: Optional[dict] = None,
         object_store_bytes: Optional[int] = None, max_workers: Optional[int] = None,
         namespace: str = "default",
         runtime_env: Optional[dict] = None) -> dict:
    """Start (or join) a cluster and connect this process as the driver.

    `runtime_env`: driver-level default applied to every task/actor this
    driver submits (reference `ray.init(runtime_env=...)`); per-task
    runtime_env keys override the driver's key-by-key."""
    global _client, _head_proc, _driver_runtime_env
    _driver_runtime_env = dict(runtime_env or {}) or None
    with _lock:
        if _client is not None:
            return _client.node_info
        if address is None and (cfg_addr := _config.get("address")):
            address = cfg_addr
        if address is not None and address.startswith("ray-tpu://"):
            # remote-driver mode (reference Ray Client, `ray://host:port`):
            # everything rides one multiplexed connection to the head-side
            # proxy — no reachability to workers/data servers/shm needed
            from ray_tpu_torch.client_proxy.client import (
                ProxyClient, parse_proxy_address)

            host, port = parse_proxy_address(address)
            client = ProxyClient(host, port)
            client.start()
            _client = client
            atexit.register(shutdown)
            return client.node_info
        if address is None:
            session = f"s{uuid.uuid4().hex[:12]}"
            cmd = [sys.executable, "-m", "ray_tpu_torch.core.head_main",
                   "--session", session,
                   "--object-store-bytes",
                   str(object_store_bytes
                       if object_store_bytes is not None else -1)]
            if num_cpus is not None:
                cmd += ["--num-cpus", str(num_cpus)]
            if num_gpus is not None:
                cmd += ["--num-gpus", str(num_gpus)]
            if resources is not None:
                cmd += ["--resources", json.dumps(resources)]
            if max_workers is not None:
                cmd += ["--max-workers", str(max_workers)]
            from ray_tpu_torch.core.resources import strip_device_env

            head_env = strip_device_env(dict(os.environ))
            _head_proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=None, text=True, env=head_env)
            line = _head_proc.stdout.readline()
            if not line.startswith("RAY_TPU_HEAD_PORT="):
                raise RuntimeError(f"head failed to start: {line!r}")
            port = int(line.split("=", 1)[1])
            host = "127.0.0.1"
        else:
            host, port_s = address.rsplit(":", 1)
            port = int(port_s)
            session = None
        client = CoreClient(host, port, session or "joined", is_driver=True)
        client.start()
        if session is None:
            client.store.session = client.node_info["session"]
            client.store._arena = None  # re-derive arena name from the session
        _client = client
        atexit.register(shutdown)
        return client.node_info


def shutdown() -> None:
    global _client, _head_proc
    # stop the metrics pusher FIRST: its next tick would race the closing
    # head connection (and pre-fix it spun forever after shutdown)
    from ray_tpu_torch.util import metrics as _metrics

    _metrics.stop_pusher()
    with _lock:
        if _client is not None:
            _client.shutdown()
            _client = None
        if _head_proc is not None:
            _head_proc.terminate()
            try:
                _head_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                _head_proc.kill()
            _head_proc = None
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def _auto_init():
    if _client is None:
        init()


# ----------------------------------------------------------------- objects
def put(value: Any) -> ObjectRef:
    _auto_init()
    return _global_client().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None) -> Any:
    # no auto-init: a ref can only come from a live cluster; auto-starting a
    # fresh one here would block forever on a foreign ref
    single = isinstance(refs, ObjectRef)
    out = _global_client().get([refs] if single else list(refs), timeout=timeout)
    return out[0] if single else out


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return _global_client().wait(list(refs), num_returns=num_returns,
                                 timeout=timeout)


def free(refs: Sequence[ObjectRef]) -> None:
    _global_client().free(list(refs))


_driver_runtime_env: Optional[dict] = None


# ------------------------------------------------------------------- tasks
def _package_renv_cached(holder, client, opts: dict):
    """Package runtime_env once per (holder, client): re-zipping the tree on
    every .remote() call would re-walk and re-hash it per submission."""
    renv = opts.get("runtime_env")
    if _driver_runtime_env:
        # driver default under per-task overrides (reference init-level
        # runtime_env merge: job config < task config, key-by-key)
        renv = {**_driver_runtime_env, **(renv or {})}
    if not renv:
        return None
    key = id(client)
    cache = getattr(holder, "_renv_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    from ray_tpu_torch.core.runtime_env import package_runtime_env

    packaged = package_runtime_env(client, renv)
    holder._renv_cache = (key, packaged)
    return packaged


def _build_resources(opts: dict) -> dict:
    res = {"CPU": float(opts.get("num_cpus", 1.0) or 0.0)}
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("resources"):
        res.update(opts["resources"])
    return {k: v for k, v in res.items() if v}


class RemoteFunction:
    def __init__(self, fn, options: dict):
        self._fn = fn
        self._options = options
        self._fn_key = None
        self._client = None
        functools.update_wrapper(self, fn)

    def _ensure_exported(self):
        client = _global_client()
        if self._fn_key is None or self._client is not client:
            self._fn_key = client.fn_manager.export(self._fn)
            self._client = client
        return self._fn_key

    def remote(self, *args, **kwargs):
        _auto_init()
        fn_key = self._ensure_exported()
        opts = dict(self._options)
        pg = opts.get("placement_group")
        num_returns = opts.get("num_returns", 1)
        from ray_tpu_torch.util import tracing

        task_opts = {"runtime_env": _package_renv_cached(
                         self, _global_client(), opts),
                     "resources": _build_resources(opts),
                     "max_retries": opts.get("max_retries", 3),
                     "max_calls": opts.get("max_calls"),
                     "num_returns": num_returns,
                     "_generator_backpressure_num_objects": opts.get(
                         "_generator_backpressure_num_objects"),
                     "placement_group": pg.id.binary() if pg is not None else None,
                     "placement_group_bundle_index": opts.get(
                         "placement_group_bundle_index"),
                     "label_selector": opts.get("label_selector"),
                     "scheduling_strategy": opts.get("scheduling_strategy", "hybrid"),
                     "name": opts.get("name") or getattr(self._fn, "__name__", "task")}
        for k in ("lineage", "data_stage"):
            # lineage: lease-path dispatches ALSO register the spec in the
            # head's lineage ledger (reconstructable on node loss);
            # data_stage: counts reconstructions into
            # data_blocks_reconstructed_total. Set by the data library.
            if opts.get(k):
                task_opts[k] = True
        with tracing.submit_span(task_opts["name"]):
            # inject INSIDE the span so the worker's execution span parents
            # to the submission span, not to its parent
            task_opts["trace_ctx"] = tracing.inject_context()
            refs = _global_client().submit_task(
                fn_key, args, kwargs, task_opts,
                num_returns=1 if num_returns == "streaming" else num_returns)
        if num_returns == "streaming":
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(refs[0].id)
        return refs[0] if num_returns == 1 else refs

    def options(self, **overrides) -> "RemoteFunction":
        rf = RemoteFunction(self._fn, {**self._options, **overrides})
        return rf

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference dag API: fn.bind())."""
        raise NotImplementedError(
            "DAGs (.bind) wait for the port's compiled graphs (ROADMAP item "
            "17)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            "use .remote()")

    def __reduce__(self):
        # ship only the definition; the export cache is rebuilt per-process
        return (RemoteFunction, (self._fn, self._options))


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 call_options: Optional[dict] = None):
        self._handle = handle
        self._name = name
        self._call_options = call_options or {}

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._handle._call(self._name, args, kwargs,
                                  group=self._call_options.get("concurrency_group"))

    def options(self, **overrides):
        return ActorMethod(self._handle, self._name,
                           {**self._call_options, **overrides})

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference dag API: actor.method.bind())."""
        raise NotImplementedError(
            "DAGs (.bind) wait for the port's compiled graphs (ROADMAP item "
            "17)")


class ActorHandle:
    def __init__(self, actor_id: ActorID, methods: dict):
        self._actor_id = actor_id
        self._methods = methods

    def _call(self, method: str, args, kwargs, group=None) -> ObjectRef:
        return _global_client().call_actor(self._actor_id, method, args, kwargs,
                                           group=group)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._methods:
            raise AttributeError(f"actor has no method {name!r}")
        # cache on the instance: `h.ping.remote()` in a hot loop must not
        # allocate a fresh ActorMethod per call (__getattr__ only fires
        # for missing attributes, so this self-memoizes)
        m = ActorMethod(self, name)
        object.__setattr__(self, name, m)
        return m

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._methods))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = options
        self._cls_key = None
        self._client = None

    def _methods_meta(self) -> dict:
        meta = {}
        for name in dir(self._cls):
            fn = getattr(self._cls, name, None)
            if not callable(fn) or name.startswith("__"):
                continue
            meta[name] = dict(getattr(fn, "_ray_tpu_method_options", {}))
        return meta

    def remote(self, *args, **kwargs) -> ActorHandle:
        _auto_init()
        client = _global_client()
        if self._cls_key is None or self._client is not client:
            self._cls_key = client.fn_manager.export(self._cls)
            self._client = client
        opts = dict(self._options)
        pg = opts.get("placement_group")
        actor_opts = {"runtime_env": _package_renv_cached(self, client, opts),
                      "resources": _build_resources({**opts, "num_cpus": opts.get("num_cpus", 0.0)}),
                      "placement_group": pg.id.binary() if pg is not None else None,
                      "placement_group_bundle_index": opts.get(
                          "placement_group_bundle_index"),
                      "label_selector": opts.get("label_selector"),
                      "scheduling_strategy": opts.get("scheduling_strategy", "hybrid"),
                      "max_restarts": opts.get("max_restarts", 0),
                      "max_concurrency": opts.get("max_concurrency", 1),
                      "concurrency_groups": opts.get("concurrency_groups"),
                      "name": opts.get("name"),
                      "namespace": opts.get("namespace", "default"),
                      "lifetime": opts.get("lifetime"),
                      "get_if_exists": opts.get("get_if_exists", False)}
        actor_id = client.create_actor(self._cls_key, args, kwargs, actor_opts,
                                       self._methods_meta())
        return ActorHandle(actor_id, self._methods_meta())

    def options(self, **overrides) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **overrides})

    def __call__(self, *args, **kwargs):
        raise TypeError("actor class cannot be instantiated directly; "
                        "use .remote()")

    def __reduce__(self):
        return (ActorClass, (self._cls, self._options))


def remote(*args, **options):
    """@remote decorator for functions and classes (with or without options)."""

    def wrap(obj):
        if isinstance(obj, type):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and callable(args[0]) and not options:
        return wrap(args[0])
    return wrap


def put_device(value) -> ObjectRef:
    """Store a device-resident value (a CUDA tensor, or a tree holding
    them) in THIS process's device object store: zero-copy for
    same-process consumers, a shm snapshot or the gang's NCCL for remote
    ones (reference RDT `tensor_transport` design,
    `gpu_object_manager.py:22-56`). `put` carries a tensor as host bytes."""
    _auto_init()
    return _global_client().put_device(value)


def method(**options):
    def deco(fn):
        fn._ray_tpu_method_options = options
        return fn

    return deco


def kill(handle: ActorHandle, *, no_restart: bool = True) -> None:
    _global_client().kill_actor(handle._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> str:
    """Cancel the task producing `ref`: queued tasks are dropped; running
    tasks get TaskCancelledError raised in their thread (force kills the
    worker). `get(ref)` then raises TaskCancelledError."""
    return _global_client().head_request(
        "cancel_task", return_id=ref.id.binary(), force=force)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    _auto_init()
    meta = _global_client().head_request("get_named_actor", name=name,
                                         namespace=namespace)
    if meta is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID(meta["actor_id"]), meta["methods"])


# ------------------------------------------------------------------- state
def nodes() -> list:
    return _global_client().head_request("list_state", kind="nodes")


def cluster_resources() -> dict:
    return _global_client().head_request("cluster_info")["total_resources"]


def available_resources() -> dict:
    return _global_client().head_request("cluster_info")["available_resources"]


class RuntimeContext:
    def __init__(self, client: CoreClient):
        self._client = client

    @property
    def worker_id(self):
        return self._client.worker_id

    @property
    def node_id(self):
        return self._client.node_info.get("node_id")

    @property
    def session(self):
        return self._client.session


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_global_client())


actor = remote  # alias
