"""Per-client proxy server: hosts ONE server-side driver for ONE remote.

Reference parity: `python/ray/util/client/server/server.py` (the
"specific server" a proxier spawns per client). The process owns a single
`CoreClient` registered as a driver with the head, so the one-client-
per-process refcounting model holds. The remote speaks:

- `client_hello` → node_info (creates the server-side driver)
- `client_put/get/wait/free` — pickled values / per-object error blobs
- `client_submit / client_create_actor / client_call_actor /
  client_kill_actor` — task + actor plane (payloads are serialized
  (args, kwargs) tuples; ObjectRefs inside materialize server-side)
- `head_rpc` + named `generator_next/generator_release` — control RPCs
  forwarded on the driver's head connection (identity-preserving)
- `ref_update` — the remote's batched live-ref transitions; this process
  holds a real ObjectRef per remote-known id, so head refcounting sees
  the remote's interest as this process's interest

Blocking calls run in executor threads; one stuck `get` never stalls
the connection's event loop.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import pickle
import sys
from typing import Dict, Optional

from ray_tpu_torch.core import protocol, serialization
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.serialization import SerializedObject


def _exc_blob(e: BaseException) -> bytes:
    try:
        return pickle.dumps(e)
    except Exception:
        return pickle.dumps(protocol.RemoteError(repr(e)))


class ProxyWorker:
    def __init__(self, head_host: str, head_port: int):
        self.head_host, self.head_port = head_host, head_port
        self.client = None                       # created at client_hello
        self._held: Dict[ObjectID, ObjectRef] = {}
        self.done = asyncio.Event()

    # ------------------------------------------------------------ handlers
    def handlers(self, loop, remote_conn=None) -> dict:
        async def _thread(fn, *a):
            return await loop.run_in_executor(None, fn, *a)

        def _require(self=self):
            if self.client is None:
                raise RuntimeError("client_hello must come first")
            return self.client

        async def client_hello():
            import functools

            def _mk():
                from ray_tpu_torch.core.client import CoreClient

                # worker-log stream: relay to the REMOTE driver instead of
                # printing into this (head-side) process's stderr — the
                # print() of a remote user's task belongs on their terminal
                async def _relay_log_lines(entries):
                    if remote_conn is not None and not remote_conn.closed:
                        loop.call_soon_threadsafe(functools.partial(
                            remote_conn.push, "log_lines", entries=entries))
                    return True

                c = CoreClient(self.head_host, self.head_port, "joined",
                               is_driver=True,
                               handlers={"log_lines": _relay_log_lines})
                c.start()
                c.store.session = c.node_info["session"]
                c.store._arena = None  # re-derive from the real session
                return c

            self.client = await _thread(_mk)
            info = dict(self.client.node_info)
            info.setdefault("session", self.client.store.session)
            return info

        async def _on_client_loop(coro_fn):
            """Await a CoreClient-conn coroutine FROM ITS OWN LOOP. The
            driver's connection lives on the CoreClient loop thread;
            awaiting it directly from this loop would create/resolve
            futures cross-loop — the resolve never wakes this loop and
            the last in-flight request hangs forever."""
            c = _require()
            return await asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(coro_fn(c), c.loop))

        async def head_rpc(method, kwargs):
            return await _on_client_loop(
                lambda c: c.conn.request(method, **(kwargs or {})))

        async def head_rpc_push(method, kwargs):
            _require().head_push(method, **(kwargs or {}))
            return True

        # ObjectRefGenerator calls these by name on its client's conn
        async def generator_next(gen_id, index):
            return await _on_client_loop(
                lambda c: c.conn.request("generator_next", gen_id=gen_id,
                                         index=index))

        async def generator_release(gen_id):
            _require().head_push("generator_release", gen_id=gen_id)
            return True

        async def ref_update(ops):
            c = _require()
            borrows = []
            for op in ops:
                kind, b = op[0], op[1]
                if kind == "i":
                    oid = ObjectID(b)
                    if oid not in self._held:
                        self._held[oid] = ObjectRef(oid)
                elif kind == "d":
                    self._held.pop(ObjectID(b), None)
                else:
                    # remote borrow begin/commit: forward to the head on
                    # this driver's connection (pins attribute to this
                    # process, released if the remote session dies)
                    borrows.append(op)
            if borrows:
                c.head_push("ref_update", ops=borrows)
            return True

        async def client_put(blob):
            c = _require()

            def _do():
                value = serialization.deserialize(
                    SerializedObject.from_view(memoryview(blob)))
                return c.put(value)

            ref = await _thread(_do)
            self._held[ref.id] = ref
            return ref.id.binary()

        async def client_get(ids, timeout=None):
            """Per-object: {"blob": serialized value} | {"exc": pickled}.
            Objects fetch concurrently under ONE shared deadline — a
            remote get(refs, timeout=T) must bound at ~T total, not N*T,
            and all-ready objects must not serialize one at a time."""
            import time as _time

            c = _require()
            refs = [ObjectRef(ObjectID(b)) for b in ids]
            deadline = None if timeout is None else \
                _time.monotonic() + timeout

            def _one(ref):
                try:
                    left = None if deadline is None else \
                        max(0.0, deadline - _time.monotonic())
                    val = c.get([ref], timeout=left)[0]
                    return {"blob": serialization.serialize(val).to_bytes()}
                except BaseException as e:  # noqa: BLE001 - marshalled to remote
                    return {"exc": _exc_blob(e)}

            return list(await asyncio.gather(
                *[_thread(_one, r) for r in refs]))

        async def client_wait(ids, num_returns, timeout, fetch_local=True):
            c = _require()
            refs = [ObjectRef(ObjectID(b)) for b in ids]
            ready, rest = await _thread(
                lambda: c.wait(refs, num_returns=num_returns,
                               timeout=timeout))
            return ([r.id.binary() for r in ready],
                    [r.id.binary() for r in rest])

        async def client_submit(fn_key, payload, options, num_returns=1):
            c = _require()

            def _do():
                args, kwargs = serialization.deserialize(
                    SerializedObject.from_view(memoryview(payload)))
                return c.submit_task(fn_key, args, kwargs, options,
                                     num_returns=num_returns)

            refs = await _thread(_do)
            for r in refs:
                self._held[r.id] = r
            return [r.id.binary() for r in refs]

        async def client_create_actor(cls_key, payload, options, methods):
            c = _require()

            def _do():
                args, kwargs = serialization.deserialize(
                    SerializedObject.from_view(memoryview(payload)))
                return c.create_actor(cls_key, args, kwargs, options, methods)

            actor_id = await _thread(_do)
            return actor_id.binary()

        async def client_call_actor(actor_id, method, payload, group=None):
            c = _require()

            def _do():
                args, kwargs = serialization.deserialize(
                    SerializedObject.from_view(memoryview(payload)))
                return c.call_actor(ActorID(actor_id), method, args, kwargs,
                                    group=group)

            ref = await _thread(_do)
            self._held[ref.id] = ref
            return ref.id.binary()

        async def client_kill_actor(actor_id, no_restart=True):
            c = _require()
            await _thread(lambda: c.kill_actor(ActorID(actor_id),
                                               no_restart=no_restart))
            return True

        async def client_free(ids):
            c = _require()
            refs = [self._held.pop(ObjectID(b), None) or ObjectRef(ObjectID(b))
                    for b in ids]
            await _thread(lambda: c.free(refs))
            return True

        return {k: v for k, v in locals().items()
                if asyncio.iscoroutinefunction(v) and not k.startswith("_")}

    def shutdown(self) -> None:
        self._held.clear()
        if self.client is not None:
            try:
                self.client.shutdown()
            except Exception:
                pass


async def amain() -> None:
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)  # live stack dump for operators
    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--port-file", required=True)
    args = p.parse_args()
    host, port_s = args.address.rsplit(":", 1)
    protocol.enable_eager_tasks(asyncio.get_running_loop())
    loop = asyncio.get_running_loop()
    pw = ProxyWorker(host, int(port_s))

    def on_connect(conn: protocol.Connection) -> None:
        conn.handlers.update(pw.handlers(loop, remote_conn=conn))
        orig_close = conn.on_close

        def on_close(c):
            if orig_close:
                orig_close(c)
            pw.done.set()  # one client per process: exit with it

        conn.on_close = on_close

    server = protocol.Server({}, on_connect=on_connect, name="cproxy-worker")
    port = await server.start(host="127.0.0.1")
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, args.port_file)
    try:
        await pw.done.wait()
    finally:
        pw.shutdown()
        await server.stop()


if __name__ == "__main__":
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        sys.exit(0)
