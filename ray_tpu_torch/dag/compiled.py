"""Compiled DAG execution: per-actor loops over native shm channels,
cross-node via remote-reader RPC channels.

Lowering (reference `python/ray/dag/compiled_dag_node.py:809` CompiledDAG +
`do_exec_tasks` :191): every ClassMethodNode becomes a READ→COMPUTE→WRITE
step in a long-running loop pushed to its actor; edges become single-slot
mutable shm channels (ray_tpu_torch/csrc/channel.cc) living in the WRITER's
process. The driver writes input channels and blocks on output channels —
per-iteration cost is condvar handoffs, bypassing the task RPC path
entirely (SURVEY §3.7: µs-scale channel reads vs ~ms task overhead).

Cross-node edges (reference remote-reader mutable objects,
`experimental/channel/shared_memory_channel.py` +
`core_worker/experimental_mutable_object_provider.cc`): a consumer on a
different node gets a `RemoteChannelReader` that reads through the writer
process's direct server (`dag_chan_read`), so a compiled pipeline can span
nodes — host-side PP stage pipelining across machines.

Counterpart of `ray_tpu/dag/compiled.py`. Every ring this driver makes is
unlinked by `teardown`, the ones it had made in its actors' processes
too (`dag_chan_close`), and those of an actor that died by name: the JAX
package leaves a dead writer's segment behind. When a stage's loop
raised, `get` raises that error rather than the closed ring it left
behind.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import (CHANNEL_PREFIX, Channel,
                                       ChannelClosedError,
                                       RemoteChannelReader, release_remote)
from ray_tpu_torch.dag.nodes import (ClassMethodNode, DAGNode, InputNode,
                                     MultiOutputNode)

# dag_step_seconds: end-to-end latency of one compiled iteration as the
# driver sees it (execute() write -> output ring read). Lazy: compiled
# DAGs can run outside an initialized metrics registry.
_step_hist = None


def _observe_step(dt: float) -> None:
    global _step_hist
    if _step_hist is None:
        try:
            from ray_tpu_torch.util import metrics

            _step_hist = metrics.Histogram(
                "dag_step_seconds",
                "Compiled-DAG iteration latency (input write to output "
                "read at the driver)",
                boundaries=[1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1,
                            0.5, 1.0, 5.0, 30.0])
        except Exception:
            return
    try:
        _step_hist.observe(dt)
    except Exception:
        pass


class CompiledDAGRef:
    """Future for one compiled execution (reference compiled_dag_ref.py)."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._value = None
        self._done = False

    def get(self, timeout: Optional[float] = 30):
        # each drain fills the OLDEST pending iteration's refs; loop
        # until OURS is filled so out-of-order gets (natural with
        # max_inflight > 1) resolve correctly instead of returning an
        # unfilled placeholder. A timeout raises WITHOUT consuming or
        # poisoning anything — ring cursors stay aligned with _pending,
        # and a later get() simply resumes the drain.
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while not self._done:
            left = None
            if deadline is not None:
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError("compiled DAG output timed out")
            self._dag._drain_until(self._idx, left)
        if isinstance(self._value, Exception):
            raise self._value
        return self._value


class CompiledDAG:
    def __init__(self, output_node: DAGNode, channel_capacity: int = 4 << 20,
                 max_inflight: int = 2):
        self.capacity = channel_capacity
        # ring depth of every edge: how many iterations the driver may
        # keep in flight before execute() backpressures on the input
        # ring. 1 = classic single-slot serialization on the slowest
        # stage; >1 overlaps stages across iterations (the compiled
        # pipelining win)
        self.max_inflight = max(1, int(max_inflight))
        self.output_node = output_node
        order = output_node.topo_order()

        self.input_nodes: List[InputNode] = [
            n for n in order if isinstance(n, InputNode)]
        self.method_nodes: List[ClassMethodNode] = [
            n for n in order if isinstance(n, ClassMethodNode)]
        if isinstance(output_node, MultiOutputNode):
            self.leaf_nodes = list(output_node.outputs)
        else:
            self.leaf_nodes = [output_node]
        for n in order:
            if not isinstance(n, (InputNode, ClassMethodNode, MultiOutputNode)):
                raise TypeError(
                    f"compiled DAGs support actor-method pipelines; got {n!r}")
        for leaf in self.leaf_nodes:
            if not isinstance(leaf, ClassMethodNode):
                raise TypeError("compiled DAG outputs must be actor methods")

        # consumers per producing node: downstream method nodes + the driver
        self.consumers: Dict[str, int] = {n.uuid: 0 for n in order}
        for n in self.method_nodes:
            for up in n.upstream():
                self.consumers[up.uuid] += 1
        for leaf in self.leaf_nodes:
            self.consumers[leaf.uuid] += 1

        self.actors: Dict[Any, Any] = {}
        for n in self.method_nodes:
            self.actors[n.actor_handle._actor_id] = n.actor_handle

        # filled by _start (placement-dependent)
        self.chan_names: Dict[str, str] = {}     # producing uuid -> name
        self.input_channels: Dict[str, Channel] = {}
        self.leaf_readers: List[Any] = []
        self._remote_created: List[Tuple[Tuple[str, int], str]] = []
        import threading

        self._loop_refs = []
        self._started = False
        self._torn_down = False
        self._pending: List[List[CompiledDAGRef]] = []
        self._drain_lock = threading.Lock()
        self._teardown_lock = threading.Lock()

    # ------------------------------------------------------------ planning
    def _start(self) -> None:
        import os

        from ray_tpu_torch.core.api import _global_client
        
        client = _global_client()
        my_node = client.node_id.binary()
        my_addr = ("127.0.0.1", client.direct_port)

        # placement of every endpoint
        actor_node: Dict[Any, bytes] = {}
        actor_addr: Dict[Any, Tuple[str, int]] = {}
        for key in self.actors:
            reply = client.head_request("get_actor_address",
                                        actor_id=key.binary())
            if reply["state"] == "DEAD":
                raise RuntimeError(
                    f"cannot compile over dead actor: "
                    f"{reply.get('death_cause')}")
            actor_node[key] = reply.get("node_id") or my_node
            actor_addr[key] = tuple(reply["address"])

        producer_key: Dict[str, Any] = {}       # uuid -> actor key | None
        for n in self.method_nodes:
            producer_key[n.uuid] = n.actor_handle._actor_id

        def producer_node(uuid: str) -> bytes:
            key = producer_key.get(uuid)
            return my_node if key is None else actor_node[key]

        def producer_addr(uuid: str) -> Tuple[str, int]:
            key = producer_key.get(uuid)
            return my_addr if key is None else actor_addr[key]

        for n in self.input_nodes + self.method_nodes:
            if self.consumers[n.uuid]:
                self.chan_names[n.uuid] = f"{CHANNEL_PREFIX}{os.urandom(6).hex()}"

        def chan_ref(up: DAGNode, consumer_node: bytes):
            """How a consumer on `consumer_node` reads `up`'s output."""
            name = self.chan_names[up.uuid]
            if producer_node(up.uuid) == consumer_node:
                return ("chan", name)
            return ("rchan", (name, producer_addr(up.uuid)))

        # create every channel IN ITS WRITER'S PROCESS before any loop
        # starts (two-phase: no attach/create races)
        for node in self.input_nodes:
            if node.uuid not in self.chan_names:
                continue
            self.input_channels[node.uuid] = Channel(
                name=self.chan_names[node.uuid], capacity=self.capacity,
                num_readers=self.consumers[node.uuid],
                num_slots=self.max_inflight)
        for n in self.method_nodes:
            if n.uuid not in self.chan_names:
                continue
            key = producer_key[n.uuid]
            client.direct_request(
                actor_addr[key], "dag_chan_create",
                name=self.chan_names[n.uuid], capacity=self.capacity,
                num_readers=self.consumers[n.uuid],
                num_slots=self.max_inflight)
            self._remote_created.append(
                (actor_addr[key], self.chan_names[n.uuid]))

        # per-actor schedules, channel refs resolved against placement
        self.actor_schedules: Dict[Any, List[dict]] = {}
        for n in self.method_nodes:
            key = n.actor_handle._actor_id
            node_of_actor = actor_node[key]
            arg_sources = []
            for a in n.args:
                if isinstance(a, DAGNode):
                    arg_sources.append(chan_ref(a, node_of_actor))
                else:
                    arg_sources.append(("const", a))
            kwarg_sources = {}
            for k, v in n.kwargs.items():
                if isinstance(v, DAGNode):
                    kwarg_sources[k] = chan_ref(v, node_of_actor)
                else:
                    kwarg_sources[k] = ("const", v)
            self.actor_schedules.setdefault(key, []).append({
                "method": n.method,
                "args": arg_sources,
                "kwargs": kwarg_sources,
                "out_chan": self.chan_names.get(n.uuid),
                # device edges (reference torch_tensor_accelerator_channel):
                # a @method(tensor_transport="device") output stays in the
                # producer's device store; only a descriptor rides the shm
                # channel, consumers fetch via the device-object plane
                "transport": (n.actor_handle._methods.get(n.method)
                              or {}).get("tensor_transport"),
            })

        # driver-side readers for the outputs
        for leaf in self.leaf_nodes:
            kind, val = chan_ref(leaf, my_node)
            if kind == "chan":
                self.leaf_readers.append(Channel.attach(val))
            else:
                self.leaf_readers.append(RemoteChannelReader(*val))

        for key, schedule in self.actor_schedules.items():
            ref = client.call_actor(key, "__rtpu_dag_exec_loop__",
                                    (schedule,), {})
            self._loop_refs.append(ref)
        self._started = True

    # ------------------------------------------------------------- control
    def execute(self, *inputs, timeout: Optional[float] = None) -> Any:
        """Write inputs; returns CompiledDAGRef(s) for the output value(s).
        `timeout` bounds the input-ring write — with max_inflight
        iterations already in flight the write backpressures until a
        ring slot frees (or raises TimeoutError, e.g. a dead stage)."""
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if not self._started:
            self._start()
        if len(inputs) < len(self.input_nodes):
            raise ValueError(
                f"need {len(self.input_nodes)} inputs, got {len(inputs)}")
        # `timeout` bounds only the FIRST ring write (the backpressure
        # point): once any input is written the iteration is committed,
        # and timing out a LATER input would leave the rings
        # desynchronized (input k holding one more value than input
        # k+1, silently mispairing every subsequent iteration). The
        # remaining writes block until their ring frees a slot, which
        # is guaranteed to happen as consumers drain earlier iterations.
        for n, node in enumerate(self.input_nodes):
            self.input_channels[node.uuid].write(
                inputs[node.index], timeout=timeout if n == 0 else None)
        refs = [CompiledDAGRef(self, i) for i in range(len(self.leaf_nodes))]
        t0 = time.perf_counter()
        for r in refs:
            r._t0 = t0
        self._pending.append(refs)
        return refs[0] if len(refs) == 1 else refs

    def _drain_until(self, idx: int, timeout: Optional[float]) -> None:
        """Read the oldest pending iteration's outputs into its ref set.

        Serialized (fence/teardown paths may race a drainer thread on
        the same DAG — unsynchronized interleaved leaf reads would pair
        iterations with the wrong refs), and RESUMABLE: a read timeout
        propagates without popping the set or advancing other leaves'
        work past it, so ring cursors and _pending stay aligned and the
        next drain continues where this one stopped. Only terminal
        channel closure poisons refs."""
        acquired = self._drain_lock.acquire(
            timeout=-1 if timeout is None else max(0.01, timeout))
        if not acquired:
            raise TimeoutError("compiled DAG output timed out")
        try:
            if not self._pending:
                raise RuntimeError("no execution in flight")
            from ray_tpu_torch.dag.runtime import materialize_channel_value

            refs = self._pending[0]
            for i, reader in enumerate(self.leaf_readers):
                if refs[i]._done:
                    continue   # resumed drain: this leaf already read
                try:
                    refs[i]._value = materialize_channel_value(
                        reader.read(timeout=timeout))
                except ChannelClosedError as e:
                    refs[i]._value = self._loop_error() or e
                refs[i]._done = True
            self._pending.pop(0)
        finally:
            self._drain_lock.release()
        dt = time.perf_counter() - getattr(refs[0], "_t0", time.perf_counter())
        _observe_step(dt)
        from ray_tpu_torch.util import tracing

        if tracing.is_recording():
            # one span per compiled iteration: start_span stamps start_ts
            # at entry, so backdate it to the execute() write
            with tracing.start_span(
                    "dag.step",
                    attributes={"ray_tpu.op": "dag_step",
                                "duration_s": dt}) as span:
                if span is not None:
                    span.start_ts = time.time() - dt

    def _loop_error(self) -> Optional[Exception]:
        """The error of a stage loop that raised (its rings were fenced
        as it ended), or None when every loop is still running or ended
        at teardown."""
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(self._loop_refs,
                                      num_returns=len(self._loop_refs),
                                      timeout=1.0)
        for ref in ready:
            try:
                ray_tpu_torch.get(ref, timeout=1.0)
            except Exception as e:   # noqa: BLE001 - the loop's own error
                return e
        return None

    def ring_snapshots(self) -> Dict[str, dict]:
        """Lock-free telemetry snapshots of every ring this driver holds a
        LOCAL handle to (input rings + same-node output rings), keyed by
        channel name. Remote-reader edges are skipped — their header
        lives in the writer's process and is sampled there. Feeds
        `publish_ring_stats` / the hot-path observatory; never blocks on
        a stalled ring."""
        out: Dict[str, dict] = {}
        if self._torn_down:
            return out
        for ch in list(self.input_channels.values()):
            try:
                out[ch.name] = ch.snapshot()
            except Exception:
                pass
        for reader in self.leaf_readers:
            if isinstance(reader, Channel):
                try:
                    out[reader.name] = reader.snapshot()
                except Exception:
                    pass
        return out

    def teardown(self, kill_actors: bool = False) -> None:
        # atomic check-then-set: the chain's shutdown and its recompile
        # thread may race here; a double native close is a use-after-free
        with self._teardown_lock:
            if self._torn_down:
                return
            self._torn_down = True
        # close() is shutdown-then-munmap-under-the-op-lock: it wakes a
        # writer blocked in execute() / a drainer blocked on an output
        # ring and only unmaps once they left the native call. Closing
        # the leaf readers also fences rings whose stage process DIED
        # (nobody else can set the closed flag), so blocked readers fail
        # over promptly instead of waiting out their full timeout.
        for ch in self.input_channels.values():
            ch.close(unlink=True)
        for reader in self.leaf_readers:
            if isinstance(reader, Channel):
                try:
                    reader.close()
                except Exception:
                    pass
        if self._remote_created:
            from ray_tpu_torch.core.api import _global_client

            client = _global_client()
            # close writer-hosted channels THROUGH the process-level RPC:
            # it runs on the worker's event loop, so it works even while
            # the exec loop occupies the actor executor. A start that
            # failed halfway made some of them too; a writer that died
            # leaves its segment to us
            for addr, name in self._remote_created:
                release_remote(client, addr, name)
        if kill_actors:
            import ray_tpu_torch

            for handle in self.actors.values():
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:
                    pass
        elif self._started:
            import ray_tpu_torch

            # loops exit via ChannelClosedError; join them
            for ref in self._loop_refs:
                try:
                    ray_tpu_torch.get(ref, timeout=10)
                except Exception:
                    pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
