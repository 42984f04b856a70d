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
  dK/dV `csrc/flash_bwd.cu`).
"""
