"""TrainWorker actor + WorkerGroup (counterpart of
`ray_tpu/train/worker_group.py`).

Parity with `python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:103` (actor group creation w/ PGs, poll_status) and
`worker.py`/`thread_runner.py` (train fn runs on a thread inside the actor).

Local ranks: in the JAX package one worker owns every chip of its host, so
every rank gets local rank 0. Here a worker holds one card, and the
runtime assigns no device ids (every worker sees every card of its node),
so the group reads each worker's node before starting it and gives it its
rank among the gang's workers on that node. The loop's device is the first
of the worker's cards, `cuda:<local rank x gpus_per_worker>`
(`ScalingConfig.worker_device`), and no two workers of a node share a card.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train import session as session_lib
from ray_tpu_torch.train.checkpoint import Checkpoint


class ShippedLoop:
    """A train loop serialized where the run is defined and deserialized
    only in the workers that run it: the controller passes it on as bytes.
    Deserialized there, a loop whose globals name torch (or a module that
    imports it) would make the controller import torch, seconds on a GPU
    host before the first worker is even asked for."""

    def __init__(self, fn: Callable):
        from ray_tpu_torch.core import serialization

        self.blob = serialization.dumps(fn)

    def load(self) -> Callable:
        from ray_tpu_torch.core import serialization

        return serialization.loads(self.blob)


@ray_tpu_torch.remote
class TrainWorker:
    """Hosts the user train function on a thread; polled by the controller."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._ctx: Optional[session_lib.TrainContext] = None
        self._error: Optional[str] = None
        self._done = False

    def setup_and_start(self, train_fn, train_config, rank, world_size,
                        local_rank, node_rank, resume_checkpoint_path,
                        backend_env: Optional[Dict[str, str]] = None,
                        generation: int = 0, run_name: Optional[str] = None,
                        dataset_shards: Optional[dict] = None):
        import os

        from ray_tpu_torch.util import tracing

        if backend_env:
            os.environ.update(backend_env)
        if isinstance(train_fn, ShippedLoop):
            train_fn = train_fn.load()
        resume = (Checkpoint(resume_checkpoint_path)
                  if resume_checkpoint_path else None)
        self._generation = generation
        self._ctx = session_lib.TrainContext(
            rank=rank, world_size=world_size, local_rank=local_rank,
            node_rank=node_rank, resume_checkpoint=resume,
            generation=generation, run_name=run_name,
            dataset_shards=dataset_shards)
        # this actor call's execute span carries the driver's trace when
        # the driver traces: capture it NOW (the train thread outlives the
        # call) so per-step spans join the run's trace
        carrier = tracing.inject_context()

        def _run():
            session_lib._set_context(self._ctx)
            try:
                with tracing.adopt_context(carrier):
                    if train_config is None:
                        train_fn()
                    else:
                        train_fn(train_config)
            except StopIteration:
                pass
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                session_lib._set_context(None)
                try:
                    # the controller kills this actor shortly after it
                    # polls done — flush synchronously BEFORE raising
                    # _done so the final steps' spans/telemetry provably
                    # beat the kill (the periodic pusher's next tick, or
                    # a post-done flush, would race it)
                    from ray_tpu_torch.util import metrics as _m

                    _m.flush(wait=True)
                except Exception:
                    pass
                self._done = True

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=f"train-rank{rank}")
        self._thread.start()
        return True

    def poll(self):
        """Drain new reports; reference worker_group.poll_status :488.
        Reports carry the group generation so a fenced group's late
        reports are distinguishable from the live gang's."""
        with self._ctx.lock:
            reports = self._ctx.reports
            self._ctx.reports = []
        return {"reports": reports, "done": self._done, "error": self._error,
                "generation": getattr(self, "_generation", 0)}

    def request_stop(self):
        if self._ctx is not None:
            self._ctx.stop_requested = True
        return True

    def node_id(self):
        return ray_tpu_torch.get_runtime_context().node_id.hex()

    def node_ip(self):
        """IP other gang members can reach this worker's host on (used by
        backends that rendezvous on rank 0, e.g. torch MASTER_ADDR)."""
        import os
        import socket

        # The node's own address where it is named (RAY_TPU_NODE_IP, as
        # the collective groups read it); else the interface that routes
        # toward a remote head (UDP connect sends no packets); else a
        # head-spawned worker on the head's host: loopback.
        from ray_tpu_torch.core import config as _config

        if os.environ.get("RAY_TPU_NODE_IP"):
            return os.environ["RAY_TPU_NODE_IP"]
        target = _config.get("head_host")
        if target and not target.startswith("127."):
            try:
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                    s.connect((target, 1))
                    return s.getsockname()[0]
            except OSError:
                pass
        return "127.0.0.1"

    def rendezvous_info(self):
        """(reachable_ip, free_port) probed on THIS host — rendezvous ports
        must be chosen where they will actually be bound (rank 0's node),
        not on the controller."""
        import socket

        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        return self.node_ip(), port

    def shutdown_worker(self):
        return True


# each worker's device, set in its env by the group from
# `ScalingConfig.worker_device` ("cpu" only when the config says
# use_gpu=False); `maybe_init_distributed` and `prepare_model` read it
WORKER_DEVICE_ENV = "RAY_TPU_TRAIN_DEVICE"


def local_ranks(node_ids: List[str]) -> List[int]:
    """Each rank's index among the ranks on its node, in rank order:
    ranks on nodes [a, b, a, a] get [0, 0, 1, 2]."""
    seen: Dict[str, int] = {}
    out = []
    for node in node_ids:
        out.append(seen.get(node, 0))
        seen[node] = out[-1] + 1
    return out


class WorkerGroup:
    """Creates and tracks the gang of TrainWorker actors.

    Each group carries a monotonically increasing `generation` (set by
    the controller) — the train-level half of the fencing story: the
    cluster epoch fences a group against control-plane restarts; the
    generation scopes collective-group rendezvous names and tags every
    polled status, so a zombie member of a killed gang can neither
    rendezvous with its successor nor have its reports mistaken for the
    live gang's (checkpoints only enter run storage via the controller
    draining the group it currently polls).
    """

    def __init__(self, scaling_config, label_selector: Optional[dict] = None,
                 placement_group=None, generation: int = 0,
                 run_name: Optional[str] = None):
        self.scaling = scaling_config
        self.run_name = run_name
        self.label_selector = label_selector
        self.placement_group = placement_group
        self.generation = generation
        self.workers: List[Any] = []
        self.actor_ids: List[str] = []     # hex ids, index == rank
        self.node_ids: List[str] = []      # hex node of each worker
        self.local_ranks: List[int] = []   # rank among its node's workers

    def start(self, train_fn: Callable, train_config: Any,
              resume_checkpoint: Optional[Checkpoint] = None,
              backend=None, datasets: Optional[dict] = None) -> None:
        n = self.scaling.num_workers
        res = self.scaling.worker_resources()
        opts: Dict[str, Any] = {"resources": res,
                                "num_cpus": res.get("CPU", 0)}
        if self.label_selector:
            opts["label_selector"] = self.label_selector
        if self.placement_group is not None:
            opts["placement_group"] = self.placement_group
        if self.scaling.placement_strategy in ("SPREAD", "STRICT_SPREAD"):
            opts["scheduling_strategy"] = "spread"
        self.workers = [TrainWorker.options(**opts).remote()
                        for _ in range(n)]
        self.actor_ids = [w._actor_id.hex() for w in self.workers]
        # node placement, recorded for the controller's death watch (a
        # node_state DEAD event for any of these hosts fails the group
        # immediately, without waiting for a poll RPC to time out), and
        # read BEFORE the start: each worker's local rank (its card) and
        # the backend's LOCAL_RANK come from it
        self.node_ids = ray_tpu_torch.get(
            [w.node_id.remote() for w in self.workers], timeout=120)
        self.local_ranks = local_ranks(self.node_ids)
        backend_envs = (backend.worker_envs(self) if backend is not None
                        else [{} for _ in range(n)])
        for env, local in zip(backend_envs, self.local_ranks):
            env[WORKER_DEVICE_ENV] = self.scaling.worker_device(local)
        from ray_tpu_torch.train.ingest import build_shards

        starts = []
        for rank, w in enumerate(self.workers):
            starts.append(w.setup_and_start.remote(
                train_fn, train_config, rank, n, self.local_ranks[rank],
                rank,
                resume_checkpoint.path if resume_checkpoint else None,
                backend_envs[rank], self.generation, self.run_name,
                # per-generation shard map: rebuilt with the CURRENT
                # (rank, world) so an elastic resize re-splits the
                # stream without duplicating or dropping global batches
                build_shards(datasets, rank, n)))
        ray_tpu_torch.get(starts, timeout=120)

    def poll(self) -> List[dict]:
        return ray_tpu_torch.get([w.poll.remote() for w in self.workers],
                                 timeout=60)

    def request_stop_all(self) -> None:
        """Ask every worker to stop at its next report — the graceful
        (checkpoint-boundary) half of an elastic resize. Best-effort:
        a worker that died since the last poll is already stopping."""
        refs = []
        for w in self.workers:
            try:
                refs.append(w.request_stop.remote())
            except Exception:
                pass
        try:
            ray_tpu_torch.get(refs, timeout=30)
        except Exception:
            pass

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
