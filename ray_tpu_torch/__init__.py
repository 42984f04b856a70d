"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference. This package keeps its module
names so each counterpart is easy to find, and imports nothing of it (and no
JAX). Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: GPT-2 inference and serving (`models.gpt2`, `models.lm`,
`serve.kv_cache`, `serve.llm`) with the flash-attention forward kernel as a
hand-written sm_90a CUDA kernel (`ops.flash_attention`, `csrc/flash_fwd.cu`).
"""
