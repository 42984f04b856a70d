"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference. This package keeps its module
names so each counterpart is easy to find, and imports nothing of it (and no
JAX). Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far:
- GPT-2 inference and serving (`models.gpt2`, `models.lm`,
  `serve.kv_cache`, `serve.llm`), with the OpenAI-compatible server, LoRA
  tenants (`models.gpt2.apply_lora`), `batch_call`, streaming and KV
  transfer between engines (`serve.llm`, `serve.prefix_store` keys,
  `serve.compiled_chain` markers, `utils.fs`);
- GPT-2 training on one device (`models.gpt2` gradients with remat and
  chunked cross-entropy, `train.spmd.compile_gpt2_train` with the optax-exact
  `default_optimizer`);
- the Llama and MoE families on one device (`models.llama`: RMSNorm, RoPE,
  grouped-query attention, SwiGLU, KV-cache decode; `models.moe`: top-k
  routing with capacity, dense dispatch), trained through
  `train.spmd.compile_model_train`;
- collectives on torch.distributed (`util.collective`: `nccl` and `gloo`
  groups met through a torch Store, the in-process `LocalCollectiveGroup`,
  the two-level `hierarchy` schedule with int8/fp8 error-feedback
  `quantize`, `WindowedReader`) and data-parallel training, one process a
  device, on a hierarchical `DeviceMesh` (`parallel.mesh`,
  `train.spmd.compile_train(mesh=...)`, `cross_worker_grad_sync`);
- the named mesh (dp, fsdp, sp, tp, ep) on DTensor, with sequence
  parallelism: ring attention running the flash kernels on chunk pairs and
  Ulysses attention (`ops.ring_attention`);
- world-size-agnostic sharded checkpoints of a whole `TrainState` in the
  JAX package's format (`train.checkpoint`, `train.spmd.save_state_sharded`
  and `restore_state_sharded`), restored in either package;
- all three flash-attention kernels of the JAX package as hand-written
  sm_90a CUDA kernels behind one `torch.autograd.Function`
  (`ops.flash_attention`; forward `csrc/flash_fwd.cu`, backward dQ and
  dK/dV `csrc/flash_bwd.cu`);
- the core runtime on one node (`core`: head, workers, tasks, actors,
  shared-memory objects with the native arena `csrc/arena_store.cc`,
  placement groups, GPUs as the "GPU" resource counted by `num_gpus`), with
  `util.metrics` and `util.tracing`; actors meet in collective groups
  through the head's KV (`util.collective.create_collective_group`). Its
  control plane imports no torch: a worker pays for torch at its first task
  that uses it;
- the core runtime across nodes: node daemons advertising `num_gpus`
  (`core.node_main`), `cluster_utils.Cluster` with head fault tolerance,
  peer spillback and objects pulled between nodes, remote drivers over
  `ray-tpu://` through the head's client proxy (`client_proxy`), the state
  API (`util.state`), `timeline`, `util.actor_pool`, `util.queue`,
  `util.multiprocessing`, `util.dask`, `util.joblib`,
  `experimental.tqdm_ray`, usage stats and the CLI's `start`/`stop`;
- the object plane's device half: device objects (`put_device`, actor
  methods with `tensor_transport="device"`; `core.device_store`,
  `core.device_transport`: shm snapshots staged by one device-to-host copy
  a CUDA leaf, the gang fetch over a collective group's NCCL), the `kv`
  collective group (`util.collective.kv_group`), the weight plane
  (`serve.weight_store`: peer cold start for `LLMEngine(checkpoint=...)`,
  LoRA adapters) and the cluster prefix tier (`serve.prefix_store`,
  `LLMServer(cluster_prefix_cache=True)`), `serve.disagg.PrefillServer`;
- compiled DAGs on native ring channels (`dag`) and the channel-driven
  1F1B pipeline (`parallel.pipeline`);
- the serve control plane (`serve`: `run`, `deployment`, the controller,
  replicas pinned by `visible_devices`, `DeploymentHandle`, the HTTP
  proxy with live-signal routing and SLO admission, `@serve.batch`,
  `@serve.multiplexed`, autoscaling with scale to zero, declarative
  configs, `serve.llm.build_llm_deployment` / `build_openai_app`), the
  compiled ingress chain (`serve.compiled_chain`), the gRPC proxy and
  disaggregated prefill/decode (`serve.disagg`);
- the streaming data plane (`data`: numpy blocks, lazy plans, the
  streaming executor with actor-pool stages, backpressure and lineage
  retry, distributed shuffle/sort/join/zip/groupby, the readers and
  writers, preprocessors) and the trainer (`train`: `ScalingConfig`, a
  card a worker unless `use_gpu=False`, the controller with its failure
  policy, death watch and elastic sizing, `WorkerGroup` giving each worker
  its own card (`cuda:<local rank x gpus_per_worker>`),
  `report`/`get_context`/`get_dataset_shard`, `DatasetShard`,
  `DataParallelTrainer`, `SpmdTrainer` on torch.distributed, and the
  torch DDP `TorchTrainer`). Neither imports torch until a loop or
  `iter_torch_batches` does.

The runtime API (`init`, `remote`, `get`, ...) loads on first use, so
`import ray_tpu_torch` stays cheap.
"""

# Core runtime API, imported lazily as in the JAX package: pure-compute users
# (models/ops/parallel) don't pay for it, and vice versa.
_CORE_API = (
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "method", "get_runtime_context", "nodes", "get_actor",
    "available_resources", "cluster_resources", "ObjectRef", "actor", "free",
    "put_device",
)


def __getattr__(name):
    if name in _CORE_API:
        from ray_tpu_torch.core import api as _api

        return getattr(_api, name)
    if name == "timeline":
        from ray_tpu_torch.util.timeline import timeline

        return timeline
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_CORE_API))
