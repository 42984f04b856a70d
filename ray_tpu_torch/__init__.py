"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference. This package keeps its module
names so each counterpart is easy to find, and imports nothing of it (and no
JAX). Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far:
- GPT-2 inference and serving (`models.gpt2`, `models.lm`,
  `serve.kv_cache`, `serve.llm`);
- GPT-2 training on one device (`models.gpt2` gradients with remat and
  chunked cross-entropy, `train.spmd.compile_gpt2_train` with the optax-exact
  `default_optimizer`);
- all three flash-attention kernels of the JAX package as hand-written
  sm_90a CUDA kernels behind one `torch.autograd.Function`
  (`ops.flash_attention`; forward `csrc/flash_fwd.cu`, backward dQ and
  dK/dV `csrc/flash_bwd.cu`).
"""
