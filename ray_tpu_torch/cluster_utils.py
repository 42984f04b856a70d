"""In-process multi-node cluster for tests — `cluster_utils.Cluster` parity.

Reference: `python/ray/cluster_utils.py:135` — N node daemons + 1 head as
separate local processes with fake resource dicts, real sockets; the primary
strategy for testing distributed logic on one machine (SURVEY §4.2 pattern 2).

Counterpart of `ray_tpu/cluster_utils.py`, with GPUs where the JAX package
counts TPU chips. Each daemon advertises the `num_gpus` it is given
(default 0: N daemons that each detected the host's cards would advertise
N times the cards), and the head gets `--num-gpus 0` unless
`head_resources` names "GPU". The core assigns no card ids, so daemons on
one machine share its cards unless `add_node(env={"CUDA_VISIBLE_DEVICES":
...})` gives each its own; the daemon's workers inherit that variable.

Unlike the reference, `kill_node` takes the node's worker processes with
the daemon (a lost machine loses its processes; on one host they would
otherwise outlive it and re-register with the head), and `shutdown` stops
the daemons and the head through their own SIGTERM path (each kills its
workers and unlinks its store) before it SIGKILLs what is left and
removes the session's `rtpt_*` segments a killed process left in
/dev/shm.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

# seconds a SIGTERMed head or daemon (and then its workers) gets to stop
# on its own before Cluster.shutdown SIGKILLs what is left
STOP_TIMEOUT_S = 10.0


class Cluster:
    def __init__(self, head_resources: Optional[Dict[str, float]] = None,
                 num_cpus: float = 0, object_store_bytes: int = 1 << 30,
                 labels: Optional[Dict[str, str]] = None,
                 enable_snapshots: bool = False):
        import uuid

        self.session = f"s{uuid.uuid4().hex[:12]}"
        self._head_args = {"num_cpus": num_cpus,
                           "object_store_bytes": object_store_bytes,
                           "head_resources": head_resources,
                           "labels": labels,
                           "enable_snapshots": enable_snapshots}
        self._head = self._spawn_head(port=0, restore=False)
        line = self._head.stdout.readline()
        assert line.startswith("RAY_TPU_HEAD_PORT="), line
        self.port = int(line.split("=", 1)[1])
        self.address = f"127.0.0.1:{self.port}"
        self._nodes: List[subprocess.Popen] = []
        self._node_ids: List[str] = []
        # every process this cluster started or saw started under it
        # (heads, daemons, their workers and proxy drivers): shutdown
        # kills whatever of these is still alive
        self._known: Dict[int, bytes] = {}
        self._remember(self._head.pid)

    def _spawn_head(self, port: int, restore: bool) -> subprocess.Popen:
        from ray_tpu_torch.core.resources import strip_device_env

        a = self._head_args
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.head_main",
               "--session", self.session,
               "--port", str(port),
               "--num-cpus", str(a["num_cpus"]),
               "--object-store-bytes", str(a["object_store_bytes"])]
        if a["head_resources"]:
            cmd += ["--resources", json.dumps(a["head_resources"])]
        if "GPU" not in (a["head_resources"] or {}):
            # the head's node is not a GPU node unless asked: detection on
            # the card's host would put a num_gpus actor there
            cmd += ["--num-gpus", "0"]
        if a["labels"]:
            cmd += ["--labels", json.dumps(a["labels"])]
        if a["enable_snapshots"]:
            cmd += ["--enable-snapshots"]
        if restore:
            cmd += ["--restore"]
        env = strip_device_env(dict(os.environ))
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                env=env)

    # ------------------------------------------------ process bookkeeping
    def _remember(self, pid: int) -> None:
        cmd = _cmdline(pid)
        if cmd:
            self._known[pid] = cmd

    def _remember_tree(self, pid: int) -> None:
        self._remember(pid)
        for child in _descendants(pid):
            self._remember(child)

    def _kill_tree_of(self, proc: subprocess.Popen) -> None:
        """SIGKILL `proc`, then the processes it had started."""
        children = _descendants(proc.pid)
        for pid in children:
            self._remember(pid)
        proc.kill()
        proc.wait(timeout=10)
        for pid in children:
            _kill_if_same(pid, self._known.get(pid))

    def processes(self) -> List[int]:
        """Live processes of this cluster: its head and daemons, the
        workers and proxy drivers under them, and any process whose
        environment names this session."""
        for proc in [self._head] + self._nodes:
            if proc.poll() is None:
                self._remember_tree(proc.pid)
        live = [pid for pid, cmd in self._known.items()
                if _cmdline(pid) == cmd]
        return sorted(set(live) | set(_session_pids(self.session)))

    def segments(self) -> List[str]:
        """This session's shared-memory segments in /dev/shm (the head's
        and per-node arenas, per-object segments)."""
        from ray_tpu_torch.core.store import SHM_PREFIX

        return sorted(glob.glob(
            f"/dev/shm/{SHM_PREFIX}*{self.session[:8]}*"))

    # -------------------------------------------------- head FT drills
    def stop_head(self) -> None:
        """SIGSTOP the head — the mid-burst pause drill: every TCP
        connection stays open but nothing answers. Daemons and clients
        must keep task throughput alive through the peer-spillback mesh
        and reconcile cleanly on `cont_head`."""
        import signal

        self._head.send_signal(signal.SIGSTOP)

    def cont_head(self) -> None:
        """SIGCONT the paused head; queued gossip, releases and head-path
        submissions drain, and the ledgers must reconcile with zero
        double-grants."""
        import signal

        self._head.send_signal(signal.SIGCONT)

    def kill_head(self) -> None:
        """SIGKILL the head process (reference GCS-kill chaos drill).
        Node daemons keep serving warm leases and reconnect when
        `restart_head` brings the control plane back."""
        self._remember_tree(self._head.pid)
        self._head.kill()
        self._head.wait(timeout=10)

    def restart_head(self, restore: bool = True, timeout: float = 30) -> None:
        """Restart the head on the SAME port/session; daemons, workers
        and drivers reconnect and the pool-reconciliation handshake
        rebuilds the resource ledger from daemon reports."""
        if self._head.poll() is None:
            self.kill_head()
        deadline = time.monotonic() + timeout
        while True:
            proc = self._spawn_head(port=self.port, restore=restore)
            line = proc.stdout.readline()
            if line.startswith("RAY_TPU_HEAD_PORT="):
                assert int(line.split("=", 1)[1]) == self.port, line
                self._head = proc
                self._remember(proc.pid)
                return
            # bind race with the dying predecessor: retry until deadline
            proc.kill()
            proc.wait(timeout=10)
            if time.monotonic() > deadline:
                raise TimeoutError(f"head did not restart: {line!r}")
            time.sleep(0.3)

    def add_node(self, num_cpus: float = 1, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 env: Optional[Dict[str, str]] = None) -> str:
        """Start a node daemon; returns its node id (hex)."""
        from ray_tpu_torch.core.resources import strip_device_env

        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_main",
               "--address", self.address,
               "--num-cpus", str(num_cpus),
               "--num-gpus", str(num_gpus)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        if labels:
            cmd += ["--labels", json.dumps(labels)]
        node_env = strip_device_env(dict(os.environ))
        node_env["RAY_TPU_NUM_GPUS"] = str(num_gpus)
        if env:
            node_env.update(env)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                env=node_env)
        line = proc.stdout.readline()
        assert line.startswith("RAY_TPU_NODE_ID="), line
        node_id = line.strip().split("=", 1)[1]
        self._nodes.append(proc)
        self._node_ids.append(node_id)
        self._remember(proc.pid)
        return node_id

    def kill_node(self, node_id_or_index) -> None:
        """Simulate node failure, by index or by the node id `add_node`
        returned (reference RayletKiller pattern / `Cluster.remove_node`).
        Targeted kills are what the chaos suite needs: 'kill the node the
        actor landed on', not 'kill some node'."""
        if isinstance(node_id_or_index, int):
            idx = node_id_or_index
        else:
            idx = self._node_ids.index(str(node_id_or_index))
        self._kill_tree_of(self._nodes[idx])

    def stop_node(self, node_id_or_index) -> None:
        """SIGSTOP (hang, don't kill) a node daemon — the hung-process
        case TCP-disconnect detection can't see."""
        import signal

        idx = (node_id_or_index if isinstance(node_id_or_index, int)
               else self._node_ids.index(str(node_id_or_index)))
        self._nodes[idx].send_signal(signal.SIGSTOP)

    def connect(self):
        import ray_tpu_torch

        info = ray_tpu_torch.init(address=self.address)
        return info

    def wait_for_nodes(self, count: int, timeout: float = 30) -> None:
        import ray_tpu_torch

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            if len(alive) >= count:
                return
            time.sleep(0.1)
        raise TimeoutError(f"cluster did not reach {count} nodes")

    def shutdown(self) -> None:
        """Stop every daemon and the head through SIGTERM (each kills its
        workers and unlinks its store), SIGKILL what is left after
        STOP_TIMEOUT_S, then remove the segments of killed processes."""
        procs = [p for p in self._nodes + [self._head] if p.poll() is None]
        for proc in procs:
            self._remember_tree(proc.pid)
            proc.send_signal(signal.SIGCONT)  # a stop_node'd one, say
            proc.terminate()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        # workers notice their head's or daemon's death on their own;
        # give them the rest of the window, then kill the stragglers
        while self.processes() and time.monotonic() < deadline:
            time.sleep(0.1)
        for pid in self.processes():
            _kill_if_same(pid, self._known.get(pid) or _cmdline(pid))
        t_end = time.monotonic() + 5
        while self.processes() and time.monotonic() < t_end:
            time.sleep(0.05)
        for seg in self.segments():
            try:
                os.unlink(seg)
            except OSError:
                pass


def _cmdline(pid: int) -> bytes:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read()
    except OSError:
        return b""


def _descendants(pid: int) -> List[int]:
    """Every live process below `pid`, from /proc's parent links."""
    children: Dict[int, List[int]] = {}
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat, "rb") as f:
                # the comm field may hold spaces and parens: split after it
                fields = f.read().rsplit(b")", 1)[1].split()
        except OSError:
            continue
        children.setdefault(int(fields[1]), []).append(
            int(stat.split("/")[2]))
    out, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), ()):
            out.append(c)
            todo.append(c)
    return out


def _session_pids(session: str) -> List[int]:
    """Processes whose environment names `session` (the workers of a
    head or a daemon; readable for this user's processes only)."""
    key = f"RAY_TPU_SESSION={session}".encode()
    out = []
    for env in glob.glob("/proc/[0-9]*/environ"):
        try:
            with open(env, "rb") as f:
                if key in f.read().split(b"\0"):
                    out.append(int(env.split("/")[2]))
        except OSError:
            continue
    return [pid for pid in out if pid != os.getpid()]


def _kill_if_same(pid: int, cmd: Optional[bytes]) -> None:
    """SIGKILL `pid` unless it has exited or its pid now names another
    program."""
    if not cmd or _cmdline(pid) != cmd:
        return
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def carve_pool(client, sched_addr, n, timeout: float = 90,
               selector: Optional[Dict[str, str]] = None) -> None:
    """Warm one daemon's pool to `n` idle workers by leasing directly
    from its scheduler and returning the grants — the carve path the
    client's lease machinery uses, minus the racing head queue. A label
    selector matching only that node keeps the carve from turning into
    a peer referral. Shared by the headless-resilience drills (tests)
    and the soak's head-paused phase."""
    import asyncio

    from ray_tpu_torch.core import protocol

    async def carve():
        conn = await protocol.connect(sched_addr[0], sched_addr[1],
                                      name=f"warm-{sched_addr[1]}")
        try:
            deadline = time.time() + timeout
            wids = []
            while len(wids) < n and time.time() < deadline:
                rep = await conn.request(
                    "lease_grant", resources={"CPU": 1},
                    label_selector=selector,
                    epoch=client.cluster_epoch or None)
                if rep and not rep.get("spill") and not rep.get("peers"):
                    wids.append(rep["worker_id"])
                else:
                    await asyncio.sleep(0.5)
            for w in wids:
                await conn.request("lease_return", worker_id=w)
            return len(wids)
        finally:
            await conn.close()

    got = asyncio.run_coroutine_threadsafe(carve(), client.loop).result(
        timeout=timeout + 10)
    assert got == n, f"carved {got}/{n} at {sched_addr}"


class VirtualNodes:
    """N fake node registrations over real sockets on a private loop —
    the reference cluster_utils strategy scaled past process counts: all
    gossip/view/shard code paths run for real, only worker spawning is
    absent (their resources never fit a task, so nothing schedules to
    them). The gossip-convergence tests drive it
    (`tests/test_torch_cluster_utils.py`).

    `interest="auto"` registers each vnode as an interest-scoped view
    subscriber (the sharded plane); None keeps legacy full-fanout."""

    def __init__(self, host: str, port: int, n: int, interest="auto"):
        import asyncio
        import threading

        self.host, self.port, self.n = host, port, n
        self.interest = interest
        self.loop = asyncio.new_event_loop()
        self.conns: List[object] = []
        self.node_ids: List[str] = []
        self.views: List[dict] = []  # per-vnode: last snap + push stats
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="vnodes")

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def start(self, timeout: float = 120):
        import asyncio

        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._bring_up(), self.loop)
        fut.result(timeout=timeout)

    async def _bring_up(self):
        import asyncio

        from ray_tpu_torch.core import protocol
        from ray_tpu_torch.core.ids import NodeID

        async def _noop(**kwargs):
            return True

        sem = asyncio.Semaphore(64)  # bounded concurrent connects

        async def _one(i: int, slot: dict):
            async with sem:
                from ray_tpu_torch.core.resource_view import ClusterView

                slot["view"] = ClusterView()

                async def _on_view(snap, _slot=slot):
                    _slot["snap"] = snap
                    _slot["pushes"] += 1
                    n_entries = (len(snap.get("nodes") or ())
                                 + sum(len(b.get("nodes") or ())
                                       for b in snap.get("shards") or ()))
                    _slot["entries_rx"] += n_entries
                    _slot["max_push"] = max(_slot["max_push"], n_entries)
                    # real consumer semantics: adopt like a daemon would
                    if "shards" in snap:
                        _slot["view"].adopt_shards(snap)
                    else:
                        _slot["view"].adopt(snap)
                    return True

                conn = await protocol.connect(
                    self.host, self.port,
                    handlers={"cluster_view": _on_view,
                              "health_ping": _noop, "spawn_worker": _noop,
                              "kill_worker": _noop, "shutdown_node": _noop,
                              "free_object": _noop, "adopt_object": _noop,
                              "drop_replica": _noop,
                              "reconcile_request": _noop, "chaos": _noop,
                              "pool_worker_died": _noop,
                              "actor_worker": _noop},
                    name=f"vnode{i}")
                nid = NodeID.generate()
                await conn.request(
                    "register_node", node_id=nid.binary(),
                    # a resource no task asks for: these nodes exist for
                    # the gossip/view plane only and never win placement
                    resources={"vslot": 1.0}, labels={"vnode": str(i)},
                    max_workers=0, data_port=0, sched_port=0,
                    interest=self.interest)
                slot["conn"] = conn
                slot["node_id"] = nid.hex()

        tasks = []
        for i in range(self.n):
            slot = {"snap": None, "pushes": 0, "entries_rx": 0,
                    "max_push": 0}
            self.views.append(slot)
            tasks.append(_one(i, slot))
        await __import__("asyncio").gather(*tasks)
        self.conns = [s["conn"] for s in self.views]
        self.node_ids = [s["node_id"] for s in self.views]

    def kill(self, i: int):
        import asyncio

        asyncio.run_coroutine_threadsafe(
            self.conns[i].close(), self.loop).result(timeout=10)

    def stop(self):
        import asyncio

        async def _close_all():
            for conn in self.conns:
                try:
                    await conn.close()
                except Exception:
                    pass

        try:
            asyncio.run_coroutine_threadsafe(
                _close_all(), self.loop).result(timeout=30)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)
