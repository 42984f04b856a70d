"""Remote-driver client: the full API surface over ONE TCP connection.

Reference parity: `python/ray/util/client/worker.py` — drop-in for
`CoreClient` in `ray_tpu_torch.core.api` when `init(address="ray-tpu://...")`
is used. Values/args are serialized locally and shipped as blobs; the
server-side driver (`client_proxy/worker.py`) materializes them against
the real cluster. Reuses the normal `RefTracker`: live-ObjectRef
transitions flush to the proxy as `ref_update` ops, and the proxy mirrors
them as real held refs, so distributed refcounting extends to the laptop
without a second protocol.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import protocol, refcount, serialization
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.function_manager import FunctionManager
from ray_tpu_torch.core.ids import ActorID, ObjectID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.serialization import SerializedObject


class ProxyClient:
    """Speaks the client-proxy protocol; used as the process's global
    client by `ray_tpu_torch.core.api` for `ray-tpu://` addresses."""

    is_proxy = True

    def __init__(self, host: str, port: int):
        self.head_host, self.head_port = host, port  # the PROXY address
        self.worker_id = WorkerID.generate()
        self.is_driver = True
        self.session = "remote"
        self.node_info: dict = {}
        self.fn_manager = FunctionManager(self)
        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, daemon=True, name="ray_tpu_torch-proxy-loop")
        self.conn: Optional[protocol.Connection] = None
        self.on_disconnect = None
        self.current_actor_id = None

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self.loop)
        protocol.enable_eager_tasks(self.loop)
        self.loop.run_forever()

    async def _on_log_lines(self, entries):
        """Relayed worker-log lines: print at THIS (remote) terminal —
        same default as a local driver."""
        from ray_tpu_torch.core import worker_logs

        worker_logs.print_driver_entries(entries)
        return True

    def start(self) -> None:
        self.ref_tracker = refcount.RefTracker(self)
        refcount.activate(self.ref_tracker)
        self._loop_thread.start()

        async def _connect():
            self.conn = await protocol.connect(
                self.head_host, self.head_port, name="client-proxy",
                handlers={"log_lines": self._on_log_lines})
            self.conn.on_close = lambda c: (
                self.on_disconnect() if self.on_disconnect else None)
            return await self.conn.request("client_hello")

        fut = asyncio.run_coroutine_threadsafe(_connect(), self.loop)
        self.node_info = fut.result(timeout=120)
        self.session = self.node_info.get("session", "remote")
        self.ref_tracker.set_enabled(True)

    def shutdown(self) -> None:
        refcount.activate(None)

        async def _close():
            if self.conn is not None:
                await self.conn.close()

        try:
            asyncio.run_coroutine_threadsafe(
                _close(), self.loop).result(timeout=5)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)

    # --------------------------------------------------------------- plumbing
    def _call(self, _rpc: str, **kwargs) -> Any:
        if self.conn is None or self.conn.closed:
            raise ConnectionError("client proxy connection lost")
        fut = asyncio.run_coroutine_threadsafe(
            self.conn.request(_rpc, **kwargs), self.loop)
        return fut.result()

    def head_request(self, method: str, **kwargs) -> Any:
        return self._call("head_rpc", method=method, kwargs=kwargs)

    def head_push(self, method: str, **kwargs) -> None:
        import functools

        self.loop.call_soon_threadsafe(functools.partial(
            self.conn.push, "head_rpc_push", method=method, kwargs=kwargs))

    # ------------------------------------------------------------------ kv
    def kv_put(self, ns: str, key: bytes, value: bytes, overwrite=True) -> bool:
        return self.head_request("kv_put", ns=ns, key=key, value=value,
                                 overwrite=overwrite)

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        return self.head_request("kv_get", ns=ns, key=key)

    def kv_del(self, ns: str, key: bytes) -> bool:
        return self.head_request("kv_del", ns=ns, key=key)

    def kv_keys(self, ns: str, prefix: bytes) -> list:
        return self.head_request("kv_keys", ns=ns, prefix=prefix)

    # ------------------------------------------------------------- objects
    def put(self, value: Any, owner=None) -> ObjectRef:
        blob = serialization.serialize(value).to_bytes()
        oid = self._call("client_put", blob=blob)
        return ObjectRef(ObjectID(oid))

    def put_device(self, value: Any) -> ObjectRef:
        raise RuntimeError(
            "put_device() requires a local cluster connection — a remote "
            "(ray-tpu://) driver has no card-local device store")

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        rows = self._call("client_get", ids=[r.id.binary() for r in refs],
                          timeout=timeout)
        out = []
        for row in rows:
            if "exc" in row:
                raise pickle.loads(row["exc"])
            value = serialization.deserialize(
                SerializedObject.from_view(memoryview(row["blob"])))
            if isinstance(value, RayTpuError):
                raise value
            out.append(value)
        return out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        by_id = {r.id.binary(): r for r in refs}
        ready, rest = self._call(
            "client_wait", ids=list(by_id.keys()), num_returns=num_returns,
            timeout=timeout)
        return [by_id[b] for b in ready], [by_id[b] for b in rest]

    def free(self, refs: Sequence[ObjectRef]) -> None:
        self._call("client_free", ids=[r.id.binary() for r in refs])

    # --------------------------------------------------------------- tasks
    def submit_task(self, fn_key: bytes, args: tuple, kwargs: dict,
                    options: dict, num_returns: int = 1) -> List[ObjectRef]:
        payload = serialization.serialize((args, kwargs)).to_bytes()
        ids = self._call("client_submit", fn_key=fn_key, payload=payload,
                         options=options, num_returns=num_returns)
        return [ObjectRef(ObjectID(b)) for b in ids]

    # -------------------------------------------------------------- actors
    def create_actor(self, cls_key: bytes, args: tuple, kwargs: dict,
                     options: dict, methods: dict) -> ActorID:
        payload = serialization.serialize((args, kwargs)).to_bytes()
        aid = self._call("client_create_actor", cls_key=cls_key,
                         payload=payload, options=options, methods=methods)
        return ActorID(aid)

    def call_actor(self, actor_id: ActorID, method: str, args: tuple,
                   kwargs: dict, group=None) -> ObjectRef:
        payload = serialization.serialize((args, kwargs)).to_bytes()
        oid = self._call("client_call_actor", actor_id=actor_id.binary(),
                         method=method, payload=payload, group=group)
        return ObjectRef(ObjectID(oid))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._call("client_kill_actor", actor_id=actor_id.binary(),
                   no_restart=no_restart)


def parse_proxy_address(address: str) -> Optional[Tuple[str, int]]:
    """`ray-tpu://host:port` → (host, port); None for other schemes."""
    if not address.startswith("ray-tpu://"):
        return None
    rest = address[len("ray-tpu://"):]
    host, sep, port_s = rest.rpartition(":")
    if not sep or not port_s.isdigit():
        raise ValueError(
            f"bad remote-driver address {address!r}: expected "
            f"ray-tpu://<host>:<port> (the port is printed by "
            f"`ray-tpu start --head`)")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # IPv6 literal
    return host, int(port_s)
