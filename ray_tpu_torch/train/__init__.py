"""ray_tpu_torch.train: distributed training orchestration + SPMD data plane
(counterpart of `ray_tpu.train`).

Orchestration layer parity: `ray.train` v2 (trainers, config, report/context,
checkpoints, dataset ingest). Data plane: `spmd.py` builds the train steps
on torch (one device, or one process a device on a mesh). The JAX
package's `JaxTrainer`, `JaxBackend` and `maybe_init_jax_distributed` are
`SpmdTrainer`, `SpmdBackend` and `maybe_init_distributed` here.

The orchestration modules import no torch, so a CPU worker that only runs
a controller or a data stage never pays for it; the `spmd` names load on
first use.
"""

from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            is_sharded_checkpoint,
                                            load_sharded,
                                            read_sharded_manifest,
                                            save_sharded)
from ray_tpu_torch.train.config import (CheckpointConfig, ElasticConfig,
                                        FailureConfig, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.ingest import DatasetShard
from ray_tpu_torch.train.session import (get_context, get_dataset_shard,
                                         report)
from ray_tpu_torch.train.torch_trainer import (TorchBackend, TorchTrainer,
                                               maybe_init_torch_distributed,
                                               prepare_data_loader,
                                               prepare_model)
from ray_tpu_torch.train.trainer import (DataParallelTrainer, Result,
                                         SpmdBackend, SpmdTrainer,
                                         TrainingFailedError,
                                         maybe_init_distributed)

# train.spmd imports torch: its names load on first use
_SPMD = ("CompiledTrain", "TrainState", "compile_gpt2_train", "compile_train",
         "cross_worker_grad_sync", "default_optimizer",
         "restore_state_sharded", "save_state_sharded")

__all__ = [
    "Checkpoint", "CheckpointManager", "CheckpointConfig", "ElasticConfig",
    "FailureConfig",
    "DatasetShard",
    "RunConfig", "ScalingConfig", "get_context", "get_dataset_shard",
    "report", *_SPMD,
    "is_sharded_checkpoint", "load_sharded", "read_sharded_manifest",
    "save_sharded",
    "DataParallelTrainer", "SpmdBackend",
    "SpmdTrainer", "Result", "TrainingFailedError", "TorchBackend",
    "TorchTrainer", "maybe_init_torch_distributed", "prepare_data_loader",
    "prepare_model",
    "maybe_init_distributed",
]


def __getattr__(name):
    if name in _SPMD:
        from ray_tpu_torch.train import spmd

        return getattr(spmd, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.train' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SPMD))
