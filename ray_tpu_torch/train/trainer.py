"""Trainers: DataParallelTrainer + SpmdTrainer (counterpart of
`ray_tpu/train/trainer.py`).

Parity with `python/ray/train/v2/api/data_parallel_trainer.py:59` (fit()
spawns a controller actor and waits). The JAX package's `JaxTrainer` gives
each worker of a multi-host slice the coordinator env for
`jax.distributed.initialize`; its counterpart here, `SpmdTrainer`, gives
each worker of a gang the env for `torch.distributed` (MASTER_ADDR/PORT
probed on rank 0's node, RANK, WORLD_SIZE, LOCAL_RANK), over NCCL when the
workers hold GPUs and gloo when the config asks for the CPU. Each worker
runs the loop on its own card (`ScalingConfig.worker_device`);
`maybe_init_distributed()` joins the group, and
the loop builds its mesh (`parallel.mesh.build_mesh`) and program
(`train.spmd.compile_gpt2_train(mesh=...)`) as a one-process-a-device run
does. This module imports no torch; `maybe_init_distributed` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core import config as _config
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import (TrainControllerActor,
                                            TrainControllerLogic)
from ray_tpu_torch.train.worker_group import WORKER_DEVICE_ENV, ShippedLoop


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: Optional[str]
    error: Optional[str]
    restarts: int = 0
    # elastic lifecycle counters: graceful grow-back restarts and
    # epoch-fence restarts (neither consumes the failure budget)
    resizes: int = 0
    fenced_restarts: int = 0
    final_world_size: Optional[int] = None

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        return [self.checkpoint] if self.checkpoint else []


class TrainingFailedError(RuntimeError):
    pass


def group_backend(group, backend: Optional[str] = None) -> str:
    """`backend`, or NCCL when the group's workers train on GPUs and gloo
    when the config asks for the CPU (`use_gpu=False`)."""
    if backend:
        return backend
    return "nccl" if group.scaling.use_gpu else "gloo"


def dist_envs(group, backend: str, timeout_s: float) -> List[Dict[str, str]]:
    """Each rank's env for `torch.distributed.init_process_group`: rank
    0's reachable host and a port probed free on rank 0's own node (a
    loopback or controller-probed pair would make the other hosts of a
    multi-host gang connect to themselves), and each rank's LOCAL_RANK
    from `group.local_ranks` (its card on its node). The timeout matches
    the 120 s gang-placement barrier in `WorkerGroup.start`."""
    host, port = ray_tpu_torch.get(
        group.workers[0].rendezvous_info.remote(), timeout=120)
    n = len(group.workers)
    return [{
        "MASTER_ADDR": host,
        "MASTER_PORT": str(port),
        "RAY_TPU_TORCH_BACKEND": backend,
        "RAY_TPU_TORCH_TIMEOUT_S": str(timeout_s),
        "RANK": str(rank),
        "WORLD_SIZE": str(n),
        "LOCAL_RANK": str(group.local_ranks[rank]),
    } for rank in range(n)]


class SpmdBackend:
    """Assigns each worker the env for `torch.distributed` (the
    counterpart of the JAX package's `JaxBackend`). Only engages for
    multi-worker groups unless `enable_distributed` says otherwise: a
    single worker trains on its one card with no process group."""

    def __init__(self, enable_distributed: Optional[bool] = None):
        self.enable_distributed = enable_distributed

    def worker_envs(self, group) -> List[Dict[str, str]]:
        n = len(group.workers)
        enabled = (self.enable_distributed
                   if self.enable_distributed is not None else n > 1)
        if not enabled:
            return [{} for _ in range(n)]
        return dist_envs(group, group_backend(group),
                         _config.get("torch_timeout_s"))


def maybe_init_distributed() -> bool:
    """Call inside a train loop to join the gang's process group if the
    backend provisioned one; on NCCL the worker's card
    (`WORKER_DEVICE_ENV`) first becomes the calling thread's device (NCCL
    refuses two ranks on one card). Returns whether a group is up: False
    for a single worker."""
    if "RAY_TPU_TORCH_BACKEND" not in os.environ:
        return False
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    backend = _config.get("torch_backend")
    if backend == "nccl":
        torch.cuda.set_device(torch.device(os.environ[WORKER_DEVICE_ENV]))
    dist.init_process_group(
        backend=backend,
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=_config.get("torch_timeout_s")))
    return True


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on a gang of workers."""

    backend = None

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[dict] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self, _in_process: bool = False) -> Result:
        resume = (self.resume_from_checkpoint.path
                  if self.resume_from_checkpoint else None)
        if _in_process or not ray_tpu_torch.is_initialized():
            # local/debug mode: controller logic inline (reference
            # local_testing_mode analog); still uses real worker actors
            ray_tpu_torch.init()
            logic = TrainControllerLogic(
                self.train_loop_per_worker, self.train_loop_config,
                self.scaling_config, self.run_config, backend=self.backend,
                resume_from=resume, datasets=self.datasets)
            out = logic.run()
        else:
            controller = TrainControllerActor.options(
                name=f"train-controller-{self.run_config.name or 'run'}"
                     f"-{id(self) & 0xffff:x}").remote()
            out = ray_tpu_torch.get(controller.run.remote(
                ShippedLoop(self.train_loop_per_worker),
                self.train_loop_config,
                self.scaling_config, self.run_config, self.backend, resume,
                self.datasets),
                timeout=None)
            ray_tpu_torch.kill(controller)
        result = Result(
            metrics=out["metrics"],
            checkpoint=(Checkpoint(out["checkpoint_path"])
                        if out["checkpoint_path"] else None),
            path=out["storage_path"],
            error=out["error"],
            restarts=out["restarts"],
            resizes=out.get("resizes", 0),
            fenced_restarts=out.get("fenced_restarts", 0),
            final_world_size=out.get("final_world_size"),
        )
        if out["state"] == "ERRORED":
            raise TrainingFailedError(out["error"])
        return result


class SpmdTrainer(DataParallelTrainer):
    """SPMD training over GPU workers (the counterpart of the JAX
    package's `JaxTrainer`, reference jax_trainer.py:19).

    Each worker holds a card (unless `scaling_config.use_gpu` is False); a
    gang of two or more joins one torch.distributed group through
    `maybe_init_distributed()` and runs the same program on a
    `parallel.mesh.build_mesh` mesh, each rank on its own card
    (`ScalingConfig.worker_device`).
    """

    def __init__(self, *args, spmd_backend: Optional[SpmdBackend] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.backend = spmd_backend or SpmdBackend()
