"""TorchTrainer: torch DDP data-parallel training over the worker group
(counterpart of `ray_tpu/train/torch_trainer.py`).

Parity: `python/ray/train/torch/` (TorchTrainer + `config.py:67
_TorchBackend` + `train_loop_utils.py` prepare_model/prepare_data_loader) —
the backend provisions a process group across the gang (MASTER_ADDR/PORT +
rank env vars, exactly the reference's setup_torch_process_group), and
`prepare_model` moves the module to the worker's device and wraps it in
DistributedDataParallel so gradient allreduce rides torch.distributed. The
group runs NCCL when the workers hold GPUs and gloo when the config asks
for the CPU; each rank's LOCAL_RANK is its rank among the gang's workers on
its node (`WorkerGroup`), where the JAX package writes 0. The SPMD path is `SpmdTrainer`. This module imports torch only
inside the functions that use it.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ray_tpu_torch.train.trainer import (DataParallelTrainer, dist_envs,
                                         group_backend,
                                         maybe_init_distributed)
from ray_tpu_torch.train.worker_group import WORKER_DEVICE_ENV


class TorchBackend:
    """Env for `torch.distributed.init_process_group` on each worker;
    `backend` None picks NCCL for GPU workers and gloo for CPU ones."""

    def __init__(self, backend: Optional[str] = None,
                 timeout_s: float = 120.0):
        self.backend = backend
        self.timeout_s = timeout_s

    def worker_envs(self, group) -> List[dict]:
        if len(group.workers) == 1:
            return [{}]  # single worker: no rendezvous (as SpmdBackend)
        return dist_envs(group, group_backend(group, self.backend),
                         self.timeout_s)


# the JAX package's name for the join; the process group is the same
maybe_init_torch_distributed = maybe_init_distributed


def _worker_device():
    """This worker's device as its group named it (`WORKER_DEVICE_ENV`);
    outside a worker, the port's default: the card, raising without one."""
    from ray_tpu_torch.utils.platform import default_device

    return default_device(os.environ.get(WORKER_DEVICE_ENV))


def prepare_model(model):
    """Move the module to the worker's device (its card, or the CPU when
    the config says `use_gpu=False`) and wrap it in DDP when a process
    group is active (reference `ray.train.torch.prepare_model`)."""
    maybe_init_torch_distributed()
    import torch.distributed as dist

    device = _worker_device()
    model = model.to(device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None)
    return model


def prepare_data_loader(data_loader):
    """Re-shard a DataLoader across the gang with DistributedSampler
    (reference `ray.train.torch.prepare_data_loader`)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return data_loader
    if data_loader.batch_size is None:
        # batch_sampler-driven loaders can't be mechanically resharded;
        # leave them untouched rather than silently degrading to
        # single-sample batches
        return data_loader
    from torch.utils.data import RandomSampler

    shuffle = isinstance(data_loader.sampler, RandomSampler)
    sampler = DistributedSampler(data_loader.dataset,
                                 num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank(),
                                 shuffle=shuffle)  # preserve eval determinism
    return DataLoader(data_loader.dataset,
                      batch_size=data_loader.batch_size,
                      sampler=sampler,
                      num_workers=0,
                      collate_fn=data_loader.collate_fn,
                      drop_last=data_loader.drop_last)


class TorchTrainer(DataParallelTrainer):
    """DDP torch training over gang-scheduled workers (reference
    `ray.train.torch.TorchTrainer`)."""

    def __init__(self, *args, torch_config: Optional[TorchBackend] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.backend = torch_config or TorchBackend()
