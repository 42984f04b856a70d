"""Asyncio message transport: length-prefixed pickle frames + RPC layer.

Plays the role of the reference's gRPC wrappers (`src/ray/rpc/`): typed
request/reply with correlation ids over persistent connections, plus
server-push messages. Includes the reference's `rpc_chaos`-style fault
injection (SURVEY.md §4.2 pattern 4) grown into a deterministic fault
plane: seeded per-method/per-edge drop, delay, and duplicate delivery,
nth-call triggers, timed partition windows, and process-kill schedules —
so tests can reproduce exact failure interleavings via config, not
external tooling (see `configure_chaos` / README "Failure model").
"""

from __future__ import annotations

import asyncio
import fnmatch
import itertools
import os
import pickle
import random
import time as _time
from collections import deque
from typing import Any, Awaitable, Callable, Dict, List, Optional

HEADER = 12  # u64 pickle-payload length + u32 out-of-band buffer count

# --- fault injection (env: RAY_TPU_TESTING_RPC_FAILURE="method:prob") -------
_chaos: Dict[str, float] = {}

# --- RPC interposition: every outbound request/push is reported as
# (connection_name, kind, method) with kind in {"req", "push"}. The warm-path
# scheduling tests count head-bound traffic through this hook to PROVE a
# dispatch never touched the head (same role as the reference's rpc_chaos
# interposition layer, minus the fault). Interposers that accept extra
# keyword arguments additionally receive "rep" events when a request's
# reply lands, carrying duration_s — the flight recorder's per-RPC
# latency feed (core/flight_recorder.py) rides this without changing the
# 3-arg hooks tests already use.
_interposers: list = []   # (fn, wants_extra)
_n_extra = 0              # count of extra-accepting interposers


def _wants_extra(fn) -> bool:
    import inspect

    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    return (len(params) > 3
            or any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                   for p in params))


def add_rpc_interposer(fn) -> None:
    global _n_extra
    wants = _wants_extra(fn)
    _interposers.append((fn, wants))
    if wants:
        _n_extra += 1


def remove_rpc_interposer(fn) -> None:
    global _n_extra
    for ent in list(_interposers):
        if ent[0] is fn:
            _interposers.remove(ent)
            if ent[1]:
                _n_extra -= 1
            return


def _interpose(name: str, kind: str, method: str, **extra) -> None:
    for fn, wants in _interposers:
        try:
            if wants:
                fn(name, kind, method, **extra)
            elif kind in ("req", "push"):
                # 3-arg hooks keep the original req/push-only contract —
                # reply and chaos events exist only for extra-kwarg
                # interposers (the flight recorder)
                fn(name, kind, method)
        except Exception:
            pass


# ------------------------------------------------------------ chaos plane
# Deterministic fault plans (reference `rpc_chaos.h` grown up): every rule
# names a fault KIND, a method glob, optionally an edge (connection-name)
# glob, and a trigger. Same seed + same spec ⇒ the same injected-fault
# sequence. Every injection is reported through the RPC interposers as a
# "chaos" event, which the flight recorder turns into
# `chaos_injected_total{method,kind}` — injected faults are observable on
# /metrics, not invisible test magic.

CHAOS_KINDS = ("drop", "delay", "dup", "partition", "kill")


class _ChaosRule:
    __slots__ = ("kind", "method", "edge", "nth", "every", "prob",
                 "delay_s", "after_s", "for_s", "count", "rng")

    def __init__(self, kind: str, method: str = "*", edge: str = "*",
                 nth: Optional[int] = None, every: Optional[int] = None,
                 prob: Optional[float] = None, delay_s: float = 0.0,
                 after_s: Optional[float] = None,
                 for_s: Optional[float] = None):
        self.kind, self.method, self.edge = kind, method, edge
        self.nth, self.every, self.prob = nth, every, prob
        self.delay_s, self.after_s, self.for_s = delay_s, after_s, for_s
        self.count = 0
        self.rng: Optional[random.Random] = None


class ChaosPlan:
    """A parsed fault plan: rules + a seed. Trigger state (per-rule call
    counters, per-rule seeded PRNGs) lives here, so two plans built from
    the same spec replay the identical fault sequence."""

    def __init__(self, rules: List[_ChaosRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self.t0 = _time.monotonic()
        self.injected: List[tuple] = []  # (method, kind) log, bounded
        for i, r in enumerate(rules):
            if r.prob is not None:
                # int-derived per-rule stream: reproducible, and rule order
                # in the spec is part of the plan identity
                r.rng = random.Random(seed * 1_000_003 + i)

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Build a plan from a spec string, ignoring legacy 'method:prob'
        parts (configure_chaos routes those to the probabilistic table)."""
        rules, seed, _legacy = _parse_chaos_spec(spec)
        return cls(rules, seed)

    # ------------------------------------------------------------ decisions
    def _window_open(self, r: _ChaosRule) -> bool:
        if r.after_s is None and r.for_s is None:
            return True
        dt = _time.monotonic() - self.t0
        start = r.after_s or 0.0
        return dt >= start and (r.for_s is None or dt < start + r.for_s)

    def _fires(self, r: _ChaosRule) -> bool:
        r.count += 1
        if r.nth is not None:
            return r.count == r.nth
        if r.every is not None:
            return r.count % r.every == 0
        if r.rng is not None:
            return r.rng.random() < r.prob
        return True

    def _record(self, edge: str, method: str, kind: str) -> None:
        if len(self.injected) < 10_000:
            self.injected.append((method, kind))
        _interpose(edge, "chaos", method, chaos_kind=kind)

    def partitioned(self, edge: str) -> bool:
        """True while a partition rule's window severs this edge."""
        for r in self.rules:
            if (r.kind == "partition"
                    and fnmatch.fnmatchcase(edge, r.edge)
                    and self._window_open(r)):
                return True
        return False

    def actions(self, edge: str, method: str) -> List[_ChaosRule]:
        """Evaluate all non-partition rules for one outbound message;
        fired rules are recorded and returned for the caller to apply."""
        out: List[_ChaosRule] = []
        for r in self.rules:
            if r.kind == "partition":
                continue
            if not fnmatch.fnmatchcase(method, r.method):
                continue
            if not fnmatch.fnmatchcase(edge, r.edge):
                continue
            if not self._window_open(r):
                continue
            if self._fires(r):
                self._record(edge, method, r.kind)
                out.append(r)
        return out


def _parse_chaos_rule(part: str) -> _ChaosRule:
    fields = part.split(":")
    kind = fields[0]
    kw: dict = {}
    pos = 1
    if len(fields) > 1 and "=" not in fields[1]:
        target = fields[1]
        pos = 2
        if kind == "partition":
            kw["edge"] = target  # partition targets an EDGE, not a method
        elif "@" in target:
            kw["method"], kw["edge"] = target.split("@", 1)
        else:
            kw["method"] = target
    for f in fields[pos:]:
        if "=" not in f:
            raise ValueError(f"bad chaos rule arg {f!r} in {part!r}")
        k, v = f.split("=", 1)
        if k == "n":
            kw["nth"] = int(v)
        elif k == "every":
            kw["every"] = int(v)
        elif k == "p":
            kw["prob"] = float(v)
        elif k == "t":
            kw["delay_s"] = float(v)
        elif k == "after":
            kw["after_s"] = float(v)
        elif k == "for":
            kw["for_s"] = float(v)
        else:
            raise ValueError(f"unknown chaos rule arg {k!r} in {part!r}")
    return _ChaosRule(kind, **kw)


def _parse_chaos_spec(spec: Optional[str]):
    """Split a spec into (plan rules, seed, legacy {method: prob})."""
    rules: List[_ChaosRule] = []
    legacy: Dict[str, float] = {}
    seed = 0
    for part in filter(None, (p.strip() for p in (spec or "").split(","))):
        if part.startswith("seed="):
            seed = int(part[5:])
        elif part.split(":", 1)[0] in CHAOS_KINDS:
            rules.append(_parse_chaos_rule(part))
        else:
            method, prob = part.rsplit(":", 1)
            legacy[method] = float(prob)
    return rules, seed, legacy


_chaos_plan: Optional[ChaosPlan] = None


def configure_chaos(spec: Optional[str] = None) -> None:
    """(Re)configure fault injection from a spec string. Legacy
    'method:prob' parts keep their probabilistic-drop semantics; parts
    with a kind prefix (drop/delay/dup/partition/kill) build a seeded
    deterministic ChaosPlan. With no argument, reads both the legacy
    `testing_rpc_failure` flag and the `chaos` flag (RAY_TPU_CHAOS)."""
    global _chaos_plan
    _chaos.clear()
    if spec is None:
        from ray_tpu_torch.core import config as _config

        spec = ",".join(filter(None, (_config.get("testing_rpc_failure"),
                                      _config.get("chaos"))))
    rules, seed, legacy = _parse_chaos_spec(spec)
    _chaos.update(legacy)
    _chaos_plan = ChaosPlan(rules, seed) if rules else None


def get_chaos_plan() -> Optional[ChaosPlan]:
    return _chaos_plan


configure_chaos()


def enable_eager_tasks(loop) -> None:
    """Python 3.12 eager tasks: a dispatched handler runs synchronously up
    to its first true suspension instead of paying a full schedule round
    trip — most control-plane handlers (task_done, put_meta, ref_update)
    complete without ever suspending, so this removes the dominant
    per-message event-loop cost."""
    factory = getattr(asyncio, "eager_task_factory", None)
    if factory is not None:
        loop.set_task_factory(factory)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """The handler raised; carries the remote traceback string."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


async def read_frame(reader: asyncio.StreamReader) -> Any:
    try:
        header = await reader.readexactly(HEADER)
        payload = await reader.readexactly(
            int.from_bytes(header[:8], "little"))
        n_bufs = int.from_bytes(header[8:12], "little")
        buffers = []
        for _ in range(n_bufs):
            ln = int.from_bytes(await reader.readexactly(8), "little")
            buffers.append(await reader.readexactly(ln))
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError) as e:
        raise ConnectionLost(str(e)) from e
    return pickle.loads(payload, buffers=buffers)


def _set_nodelay(writer) -> None:
    """Small request/reply frames + Nagle's algorithm = ~40ms stalls per
    round trip; every control-plane socket must be TCP_NODELAY."""
    import socket as _socket

    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass


def write_frame(writer: asyncio.StreamWriter, msg: Any) -> None:
    """Frame = header + pickle payload + out-of-band buffers.

    `pickle.PickleBuffer`-wrapped values in `msg` travel as separate
    buffers, skipping pickle's in-band copy on both sides — the bulk-data
    path (object chunk transfer) rides this zero-copy."""
    buffers: list = []
    payload = pickle.dumps(msg, protocol=5, buffer_callback=buffers.append)
    writer.write(len(payload).to_bytes(8, "little")
                 + len(buffers).to_bytes(4, "little") + payload)
    for b in buffers:
        raw = b.raw()
        writer.write(raw.nbytes.to_bytes(8, "little"))
        writer.write(raw if raw.contiguous else bytes(raw))


class Connection:
    """Bidirectional RPC over one TCP connection.

    Either side may call `request`; either side serves via its handler table.
    Message shapes: ("req", id, method, args_dict), ("rep", id, result),
    ("err", id, repr_string), ("push", method, args_dict).
    """

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 handlers: Optional[Dict[str, Callable[..., Awaitable[Any]]]] = None,
                 name: str = "?"):
        self.reader, self.writer = reader, writer
        self.handlers = handlers or {}
        self.name = name
        self._seq = itertools.count()
        self._pending: Dict[int, asyncio.Future] = {}
        self._task: Optional[asyncio.Task] = None
        self._closed = asyncio.Event()
        self.on_close: Optional[Callable[["Connection"], None]] = None
        # at-most-once dispatch: duplicate request frames (chaos `dup`
        # faults, or a confused peer resending on one connection) must not
        # run a handler twice — remember recently seen request ids
        self._rid_seen: set = set()
        self._rid_order: deque = deque()

    def start(self) -> None:
        self._task = asyncio.create_task(self._read_loop(), name=f"conn-{self.name}")

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await read_frame(self.reader)
                kind = msg[0]
                if kind in ("req", "push") and _chaos_plan is not None \
                        and _chaos_plan.partitioned(self.name):
                    # inbound half of a severed edge: the frame arrived on
                    # the wire but the partition drops it before dispatch
                    # (replies still land so pre-window requests resolve)
                    _chaos_plan._record(self.name, msg[2] if kind == "req"
                                        else msg[1], "partition")
                    continue
                if kind == "req":
                    _, rid, method, kwargs = msg
                    if rid in self._rid_seen:
                        continue  # duplicate delivery: dispatched already
                    self._rid_seen.add(rid)
                    self._rid_order.append(rid)
                    if len(self._rid_order) > 2048:
                        self._rid_seen.discard(self._rid_order.popleft())
                    asyncio.create_task(self._dispatch(rid, method, kwargs))
                elif kind == "push":
                    _, method, kwargs = msg
                    asyncio.create_task(self._dispatch(None, method, kwargs))
                elif kind == "rep":
                    fut = self._pending.pop(msg[1], None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg[2])
                elif kind == "err":
                    fut = self._pending.pop(msg[1], None)
                    if fut is not None and not fut.done():
                        fut.set_exception(RemoteError(msg[2]))
        except (ConnectionLost, asyncio.CancelledError):
            pass
        finally:
            self._closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(f"connection {self.name} closed"))
            self._pending.clear()
            try:
                self.writer.close()
            except Exception:
                pass
            if self.on_close:
                self.on_close(self)

    async def _dispatch(self, rid: Optional[int], method: str, kwargs: dict) -> None:
        try:
            handler = self.handlers[method]
            result = await handler(**kwargs)
            if rid is not None:
                write_frame(self.writer, ("rep", rid, result))
        except Exception as e:  # noqa: BLE001 - must serialize any failure
            import traceback

            if rid is not None:
                try:
                    write_frame(self.writer, ("err", rid, traceback.format_exc()))
                except Exception:
                    pass
            else:
                print(f"[ray_tpu_torch] push handler {method} failed: {e}", flush=True)

    def request_future(self, rpc: str, **kwargs) -> asyncio.Future:
        """Send the request now; return the reply future without awaiting.

        Lets callers pipeline ordered requests (write in program order, await
        replies concurrently) — the role of the reference's async gRPC
        callbacks in the actor submit queue."""
        if prob := _chaos.get(rpc):
            if random.random() < prob:
                _interpose(self.name, "chaos", rpc, chaos_kind="drop")
                raise ConnectionLost(f"chaos: injected failure for {rpc}")
        acts = self._chaos_outbound(rpc)
        if _interposers:
            _interpose(self.name, "req", rpc)
        if self.closed:
            raise ConnectionLost(f"connection {self.name} already closed")
        rid = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        self._chaos_write(("req", rid, rpc, kwargs), acts)
        if _n_extra:
            t0 = _time.perf_counter()

            def _report(f, _rpc=rpc, _t0=t0):
                _interpose(self.name, "rep", _rpc,
                           duration_s=_time.perf_counter() - _t0,
                           ok=(not f.cancelled()
                               and f.exception() is None))

            fut.add_done_callback(_report)
        return fut

    async def request(self, rpc: str, **kwargs) -> Any:
        return await self.request_future(rpc, **kwargs)

    def _chaos_outbound(self, rpc: str) -> list:
        """Partition/drop raise or swallow; delay/dup return rules applied
        at frame-write time. No-op (empty list) without an active plan."""
        plan = _chaos_plan
        if plan is None:
            return ()
        if plan.partitioned(self.name):
            plan._record(self.name, rpc, "partition")
            raise ConnectionLost(
                f"chaos: partition severs edge {self.name}")
        acts = plan.actions(self.name, rpc)
        for r in acts:
            if r.kind == "kill":
                # process-kill schedule: the configured nth/every/p call
                # takes the whole process down, SIGKILL-abrupt
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            if r.kind == "drop":
                raise ConnectionLost(f"chaos: injected failure for {rpc}")
        return acts

    def _chaos_write(self, msg: tuple, acts) -> None:
        dup = any(r.kind == "dup" for r in acts)
        delay = max((r.delay_s for r in acts if r.kind == "delay"),
                    default=0.0)
        if delay > 0:
            asyncio.get_running_loop().call_later(
                delay, self._write_late, msg, dup)
            return
        write_frame(self.writer, msg)
        if dup:
            write_frame(self.writer, msg)

    def _write_late(self, msg: tuple, dup: bool) -> None:
        if self.closed:
            return
        try:
            write_frame(self.writer, msg)
            if dup:
                write_frame(self.writer, msg)
        except Exception:
            pass  # the read loop reaps the connection

    def push(self, rpc: str, **kwargs) -> None:
        if not self.closed:
            try:
                acts = self._chaos_outbound(rpc)
            except ConnectionLost:
                return  # a dropped/partitioned push vanishes silently
            if _interposers:
                _interpose(self.name, "push", rpc)
            self._chaos_write(("push", rpc, kwargs), acts)

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass


async def connect(host: str, port: int, handlers=None, name: str = "?") -> Connection:
    reader, writer = await asyncio.open_connection(host, port)
    _set_nodelay(writer)
    conn = Connection(reader, writer, handlers, name=name)
    conn.start()
    return conn


class Server:
    """TCP server that wraps each inbound connection in a Connection."""

    def __init__(self, handlers: Dict[str, Callable[..., Awaitable[Any]]],
                 on_connect: Optional[Callable[[Connection], None]] = None,
                 name: str = "server"):
        self.handlers = handlers
        self.on_connect = on_connect
        self.name = name
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set[Connection] = set()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        async def handle(reader, writer):
            conn = Connection(reader, writer, dict(self.handlers), name=self.name)
            self.connections.add(conn)
            conn.on_close = self.connections.discard
            if self.on_connect:
                self.on_connect(conn)
            conn.start()

        def handle_nodelay(r, w):
            _set_nodelay(w)
            return handle(r, w)

        self._server = await asyncio.start_server(handle_nodelay, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for conn in list(self.connections):
            await conn.close()
