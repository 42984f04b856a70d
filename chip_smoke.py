#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. build every CUDA kernel of the port from ray_tpu_torch/csrc with nvcc
   (sm_90a), print the card's name and power limit, and each kernel
   instantiation's registers and spills (ptxas -v) and tensor-core
   instructions (cuobjdump -sass);
2. hold each kernel (K1 forward, K2 dQ, K3 dK/dV) against its plain PyTorch
   version on the card, at the shapes and strides the main paths give it
   (training: B=24, q/k/v split from the QKV product, dO transposed) and a
   few more, hold the K1+K2+K3 gradients against autograd through
   mha_reference, check that two K2 runs and two K3 runs give the same
   bits, and time
   kernel, plain version and the library call that computes the same
   function;
3. attention forward + backward at B=4 H=12 Dh=64 bf16 causal for
   T in {1024, 2048, 4096}: the flash kernels against SDPA and the dense
   path;
4. GPT-2-125M forward and loss at full width (seeded random weights,
   B=4, T=1024) through the flash kernel, against the dense path;
5. the continuous-batching server at full width answering requests, with
   chunked prefill and a prefix-cache hit, greedy output equal with and
   without prefix reuse;
5b. the OpenAI-compatible server at full width with three rank-8 LoRA
   adapters under an LRU of two: each adapter moves greedy output and the
   base's stays, the evicted engine's thread ends and its memory is freed,
   the merge on the card within its bound of the CPU merge, the adapter's
   first-token logits against the flash forward (K1), a batch_call burst
   with one malformed item, chat streaming equal to the request without
   it, and KV export/import between engines with deferred admission;
6. GPT-2-125M training at full width (bench.py's defaults: B=24, T=1024,
   remat "dots", flash attention) through compile_gpt2_train: exact kernel
   launches per step, a falling loss on a repeated batch, the first steps
   equal to the dense path's, step time, tokens/s and MFU;
6b. data parallel on torch.distributed (phase_dp): (a) every op of the
   collective module API on CUDA tensors through a world-1 NCCL group, and
   the int8/fp8 quantizer at GPT-2-125M's gradient size bit-equal to the
   CPU's, timed; (b) GPT-2-125M with phase 6's configuration through
   compile_gpt2_train on a world-1 hierarchical mesh over NCCL, 5 steps
   bit-equal to the one-device step, exact launches, nothing through the
   host, the sync timed; (c) two spawned ranks sharing the card over gloo
   (NCCL refuses two ranks on one GPU), B=4 a rank, as two hosts (f32,
   then int8 with error feedback) and as one host of two (f32, the intra
   reduce-scatter and all-gather): params bit-equal across ranks after
   every step, losses and grad norms within their bounds of one process
   at B=8 over 4 steps (int8-EF: grad norms of the two steps before the
   first update), the sync timed (gloo: says nothing of NCCL);
6c. the named mesh on DTensor (phase_mesh): (a) GPT-2-125M with phase 6's
   configuration through compile_gpt2_train on a world-1 NCCL build_mesh
   mesh with every axis at 1, 5 steps bit-equal to the one-device step,
   exact launches, the step timed against one device's (DTensor's
   dispatch); (b) gloo on CUDA tensors: each collective DTensor's
   redistributions use, in its own pair of spawned ranks sharing the card,
   so a crash names its op; (c) where gloo survives the all-gather every
   sharded mesh needs, two ranks sharing the card: GPT-2-125M at full
   width, global B=8 T=1024, on tp=2 (K1-K3 on 6 local heads) and fsdp=2,
   3 steps each, and mixtral-8x7b's widths cut to one layer on ep=2 (B=2
   T=2048, 2 steps): losses and grad norms within their bounds of one
   process at the same global batch, GPT-2's gathered params too, per-rank
   launches, one step's collectives by kind (CommDebugMode), step ms. Where
   gloo does not survive it, (c) runs over NCCL on two cards in
   tests/test_torch_cuda.py::test_mesh_across_cards (`mesh_pair`);
7. Llama inference at full width and depth, llama3-8b (seeded random
   weights drawn on the card): the B=1 T=4096 forward through K1 at Dh=128
   (32 launches) against the dense path, then KV-cache decode at B=4: a
   32-token prompt fed token by token and 32 greedy tokens, the decode
   logits held against the flash forward's at every position;
8. Llama training at full width and depth, tinyllama-1.1b (B=8, T=2048,
   remat, flash, grouped-query K/V) through compile_model_train: exact
   launches per step, a falling loss, the first steps equal to the dense
   path's, step time, tokens/s, MFU and a profiled step;
9. MoE at mixtral-8x7b's widths cut to 2 layers: forward with the aux
   metrics, flash against dense on the first step's loss, and 5 training
   steps through compile_model_train with exact launches per step;
10. ring attention (phase_ring): the ring's per-rank schedule, the one the
   distributed path runs, driven for sp virtual ranks on the card with an
   in-process rotation, at Llama-3-8B's attention widths at T=16384 on
   sp=4 and at GPT-2-125M's training shape on sp=2: sp(sp+1)/2 launches
   of each kernel, the ring's out, lse and gradients against one K1 + K2 +
   K3 over the whole sequence, each chunk pair against its plain versions,
   the ring timed against one-shot flash; the non-causal chunk pair's
   kernels timed against their bounds, plain versions and SDPA;
11. checkpoints (phase_checkpoint): GPT-2-125M's whole TrainState after 2
   steps of phase 6's configuration saved and restored, gathering and
   streaming: bit-equal leaves and a resumed step bit-equal to the
   unbroken run's, MB written and ms;
12. the GPipe pipeline (phase_pipeline): GPT-2-125M at phase 6's
   configuration through compile_pipeline_train on 4 virtual stages of the
   card (the schedule the ranks run, driven in one process) with 8
   microbatches, 5 steps against compile_model_train on one device: loss
   within 0.01 and grad norm within 2 % at every step, K1/K2/K3 launches
   exactly as the schedule gives them (stated before the run), step ms,
   MFU, peak memory and a profiled step;
13. the compositions one card holds (phase_compose): (b) GPT-2-125M at
   phase 6's configuration on the 7-D hierarchical mesh at world 1 over
   NCCL (full_hierarchical_mesh, every degree 1: the composed path, params
   and rows as DTensors on the model sub-mesh, the two-level sync on the
   local shards), 5 steps bit-equal to one device with 24/12/12 launches a
   step; (a) the tensor-parallel serving engine with both shards on the
   card at phase 5's configuration against tp=1 (tp_engine_check): every
   sampled logits row up to the first parting within TOL_TP_LOGITS, the
   greedy streams equal or parting only at near-ties under that bound,
   tok/s and TTFT of a burst on each;
14. the core runtime on the card (phase_runtime): ray_tpu_torch.init with
   the GPUs detected (equal to torch.cuda.device_count()) and the head
   holding no CUDA context (absent from nvidia-smi's compute pids, no
   libcuda mapped); phase 5's server in a num_gpus=1 actor answering
   prompts a and b with the greedy tokens of the same server in this
   process and a's first-token logits (gpt2.forward: K1) within
   TOL_LOGITS; one step of phase 6's training in a num_gpus=1 task within
   0.01 loss and 2 % grad norm of the same step here; the actor's and the
   task's K1/K2/K3 launches, counted in their own processes, exactly as
   stated before the run; a task's 256 MiB bf16 CUDA tensor got back as a
   bit-equal CPU tensor with its bytes out of band; the get timed as a
   latency, puts of the same bytes (a CPU tensor, a numpy array, the CUDA
   tensor) into untouched and into reused arena pages, a host memcpy into
   a fresh and a touched buffer, a worker's start and warm round trips of
   an actor call and a no-op task;
15. the runtime across nodes on the card (phase_multinode), under store
   isolation: cluster_utils.Cluster with a head holding no GPU and two
   node daemons of num_gpus=1 each on the one card (zones a and b), none
   of the three mapping libcuda; phase 5's server in a detached
   num_gpus=1 actor on a daemon's node (N1) with phase 14's driver-side
   greedy tokens, a's first-token logits within TOL_LOGITS and 12/0/0
   launches counted in its process; a task's 256 MiB bf16 CUDA tensor
   made on the other node (N2) and got in the head's namespace through the
   chunked data plane, bit-equal and out of band, timed as GB/s; the head
   SIGKILLed and restarted with --restore while the actor lives: the
   actor keeps its process (its daemon reports it and the head re-adopts
   it) and its tokens, the epoch is bumped, GPU total 2 with none
   available on N1, no ledger below zero, and a num_gpus=1 task pinned to
   N1 from the moment the head is back does not run (no double grant);
   N1 killed: the actor
   restarts on N2 with the same tokens and launches, the time from the
   kill to its first answer logged; a remote driver with no visible card
   gets prompt a's tokens through the head's client proxy
   (ray-tpu://) without mapping libcuda; the shutdown leaves no process
   and no rtpt_* segment of the session.
16. the object plane's device half (phase_objects), on phase 15's cluster
   shape: (a) a num_gpus=1 actor on node a keeps prompt a's first-token
   logits (12/0/0 launches in its process) and phase 14's 256 MiB bf16
   tensor on its card as a device object (tensor_transport="device"); its
   own get returns the living tensors (same data_ptr); this process and an
   actor on node a get CUDA tensors on their own cuda:0, bit-equal, from
   ONE snapshot the owner stages (one device-to-host copy a CUDA leaf,
   meta under 4096 B, every byte out of band); an actor on node b gets
   them through the chunked pull; every ref dropped, the owner's device
   store empties and the snapshot's arena bytes come back; gets timed by
   route; (b) phase 14's server built from the seeded GPT-2-125M
   checkpoint: R1 on node a reads it (source "checkpoint") and publishes
   it on the weight plane, R2 on node b pulls it from R1 (source "p2p")
   with no head RPC in its build, its params bit-equal to R1's, host peak
   within max_in_flight x chunk_bytes, phase 14's greedy tokens, R1's
   logits bit-equal, 12/0/0 in its process, resolve and pull timed; (c)
   with cluster_prefix_cache=True, R2 warm-starts a 600-token prompt R1
   served: one store hit, every whole 16-token block of len-1 covered,
   fewer prefill steps than R1's, R1's tokens, no head RPC on the warm
   path, TTFT of both.
17. compiled DAGs and the channel-driven 1F1B pipeline (phase_compiled),
   the runtime advertising 4 GPUs on the one card: (a) GPT-2-125M as a
   compiled DAG of two num_gpus=1 actors (A: the embedding and blocks
   0-5, its output a device object; B: blocks 6-11 and the unembedding),
   B=4 T=1024, 21 iterations: every result (each row's next-token logits
   and each position's f32 sum of its logits) bit-equal to this process's
   forward on the same weights, K1 6 an iteration in each actor's own
   process, A's device store at most 2 after teardown, no ring left; the
   median iteration against the same chain by chained .remote calls; (b)
   the 1F1B pipeline of four ChannelPipelineStage actors of 3 blocks
   (num_gpus=1 each; the first embeds, the last unembeds with its own
   copy of wte and takes the cross-entropy), B=8 T=1024 in 4
   microbatches, device edges: one eager step (eager_pipeline_step),
   three compiled (CompiledPipeline), one eager again, each loss within
   0.01 of the same full-batch SGD steps in this process, every param
   within PP_PARAM_SHARE of its largest update there, K1/K2/K3 a step in
   each stage's process exactly as the code gives them (24/12/12 on
   stages 0-2, 12/12/12 on the last), every ring and device object gone
   after close; step ms and the card's busy share (nvidia-smi).
18. the serve control plane (phase_serve_plane): a head with no GPU and a
   daemon advertising 2 GPUs on the one card, the HTTP proxy; (a)
   build_llm_deployment(gpt2-125m) at phase 14's engine configuration on
   two num_gpus=1 replicas: prompts a and b through the proxy (a and b at
   once, twice: one on each replica, each alone in its engine) and
   through a DeploymentHandle, every token list equal to
   phase 14's driver-side server's, both replicas answering; warm request
   ms by route (HTTP, handle, this process's server) and the in-process
   TTFT; build_openai_app on one replica: an SSE stream of prompt a
   (text/event-stream, [DONE] last) whose text is the decode of those
   tokens, its TTFT through the proxy; (b)+(c) a scorer deployment
   (num_gpus=1, @serve.batch of 4) running gpt2.forward (K1 once a layer)
   at T=1024 with min_replicas=0: parked when deployed, woken by the
   first of 8 concurrent HTTP requests, replicas 0 -> 1 -> 0, the cold
   first answer timed, each request's logits within TOL_LOGITS of this
   process's B=1 forward, at least one batch of two or more, K1 = 12 x
   the forwards counted in the replica; nothing of the session left.
   Across cards, tests/test_torch_cuda.py::test_serve_replicas_across_cards
   puts the two replicas on two daemons of one card each.
   Across four cards, tests/test_torch_cuda.py::
   test_compiled_pipeline_across_cards runs (b)'s pipeline a stage a card
   (compiled_pp_cards), every ring crossing nodes.
Phase 10 also runs the ring at a ragged chunk (Llama-3-8B widths,
T=16000 on sp=4: chunks of 4000 padded to 4096, the padded keys masked by
K1's and K2's kv_len) and holds each padded chunk pair against the plain
versions; phase 2 also holds the kernels at a head dim of 80, which the
wrapper pads to 128.
Across cards, tests/test_torch_cuda.py::test_pp_across_cards runs
`pp_cards`: GPT-2-125M on pp=2 over NCCL on two cards against one process,
Llama-3-8B at full width on pp=4 over four against one card's no-grad
loss, and TinyLlama-1.1B on pp=2 x sp=2 over four (the ring inside every
stage) against one card's first step, its peak memory a rank beside the
prediction; test_mesh_across_cards runs `hier_cards` (GPT-2-125M on the
hierarchical mesh Topology(2, 1) x tp=2, four cards) and
test_tp_engine_across_cards the tp engine over two cards. Across two cards, tests/test_torch_cuda.py::test_sp_across_cards runs
`sp_pair`: GPT-2-125M on sp=2 with ring and Ulysses and tinyllama-1.1b with
ring over NCCL against one process, and the sp=2 checkpoint on one card.
Phase 2 also holds the kernels at the Llama paths' shapes (tinyllama's
training, llama3-8b's forward, K/V expanded from the KV heads) and times
that expansion. Phases 4-5 (GPT-2 inference), 5b (the OpenAI server), 6
(GPT-2 training), 6b's (b) (data-parallel training), 6c's (a) and (c)
(sharded training), 7, 8, 9, each case of 10, 11, 12 and 13's (b) are
the main paths: every kernel's launch count is set to 0 before each and read right
after; in phases 14-18 each actor, task or replica counts its own launches
from 0. The line before the last lists the kernels as JSON, with the GPT-2
training path's counts under "launches", every path's under
"launches_by_path", the ring's non-causal chunk pair under "ring_chunk",
its ragged one under "ring_ragged_chunk" and the head dim 80 case under
"head_dim_80"; the last line is {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero without that line. Needs
one CUDA card; imports nothing of JAX.

TF32 is off for matmuls and cuDNN (set below), so float32 products are full
float32 and the f32 comparisons are meaningful.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import gc
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import weakref
from concurrent.futures import Future

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt2, llama, moe
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import ring_attention as ring
from ray_tpu_torch.serve.compiled_chain import CHAIN_ERR
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, OpenAIServer
from ray_tpu_torch.parallel.mesh import (MeshConfig, build_hierarchical_mesh,
                                         build_mesh, full_hierarchical_mesh,
                                         hier_groups)
from ray_tpu_torch.train import checkpoint as ckpt_lib
from ray_tpu_torch.train import spmd
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective._comm import HOST_STAGED
from ray_tpu_torch.util.collective.hierarchy import BYTES as hier_bytes
from ray_tpu_torch.util.collective.hierarchy import Topology, hier_grad_sync
from ray_tpu_torch.util.collective.quantize import QuantizedAllreduce

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its operations over the
# peak for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs its plain version (the same online-softmax arithmetic in f32).
# f32: the reference kernel test's own tolerance (the f32 route is f32 FMAs,
# no TF32). bf16: the tensor-core K1 rounds P to bf16 once more before its
# product with V (f32 accumulation), which adds about 2^-9 relative per term,
# random in sign, so the sum of P V moves by far less than one bf16 step of
# O; O itself rounds once to bf16 (2^-8 relative of |O| <= ~4). Both fit in
# 1e-2 + 1e-2*|ref|; lse is f32 in both (l sums the f32 P).
TOL_PLAIN = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
TOL_LSE = dict(atol=1e-4, rtol=1e-5)
# Kernel vs mha_reference: in bf16 the reference rounds the probabilities to
# bf16 before its product with V (2^-8 relative per weight) and multiplies in
# bf16, so the bound is wider.
TOL_MHA = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
# K2/K3 vs their plain versions (the same blockwise arithmetic in f32): f32,
# the reference's gradient tolerance (tests/test_ops_attention.py); bf16,
# as for K1: both round dQ, dK, dV once from f32, one bf16 step apart, and
# the tensor-core kernels round their score operands to bf16 before the
# products that follow (f32 accumulation): K2 dS before dS K, K3 P^T and
# dS^T before their products with dO and Q. That is about 2^-9 relative per
# term, random in sign, far below 1e-2 in the sums.
TOL_GRAD_PLAIN = {torch.float32: dict(atol=5e-4, rtol=1e-3),
                  torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# K1+K2+K3 gradients vs autograd through mha_reference: f32, the reference's
# tolerance; bf16, against mha_reference's f32 gradients on the same
# (bf16-valued) inputs: the kernels round dQ, dK, dV once (one bf16 step,
# 2^-8 relative) and take Delta from the bf16-rounded O, a second rounding
# of the same size, so twice the bf16 plain tolerance.
# The bound is tight in short causal rows: in row 1 the two keys' dS cancel
# in exact arithmetic, and rounding dS to bf16 (in the kernels as in SDPA)
# can leave a small dQ entry past it; tests/grad_bound_diagnosis.py breaks
# such a case down (ROADMAP queue 3).
TOL_GRAD_MHA = {torch.float32: dict(atol=5e-4, rtol=1e-3),
                torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# GPT-2-125M logits, bf16 activations through 12 layers, flash vs dense
# attention (and engine prefill vs forward): logits have std ~0.55 at this
# init; the two paths round at different places.
TOL_LOGITS = 0.1
# GPT-2-125M training, flash vs dense from the same params on the same batch:
# the mean loss over 24,576 tokens averages the per-logit rounding
# differences (|d| up to TOL_LOGITS, mean about 0) to well under 1e-2; the
# gradient norm is a sum of squares over 124 M entries that each carry
# bf16 rounding (2^-8 relative), taken in f32, so 2 % relative.
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD_NORM = 2e-2
# Llama logits through 32 layers in bf16, flash vs dense forward and KV-cache
# decode vs forward. The paths round O and the bf16 residual stream at other
# places; each layer's roundings are independent of the last's, so the gap
# grows as the square root of the depth. At llama3-8b's widths (logits std
# ~1.28, the largest ~7, where one bf16 step is 0.031) a CPU run of 1, 2 and
# 4 layers put max |d| near 2, 2.5 and 4 bf16 steps, which extrapolates to
# ~11 steps (0.33) at 32 layers and a mean |d| of ~0.05. The bounds: max |d|
# 0.5, mean |d| 0.1 (a head mapped to the wrong KV head moves the mean by
# about the logits' std).
TOL_LLAMA_MAX = 0.5
TOL_LLAMA_MEAN = 0.1

# The OpenAI phase's LoRA adapters: rank 8 on the stacked QKV and MLP-in
# weights, A and B drawn by numpy from LORA_SEED with std LORA_STD, alpha 16:
# delta = 2 A @ B has std 2·sqrt(8)·0.094² = 0.05, 2.5x the weights' 0.02,
# enough to move greedy output. The merge on the card is held against the
# same merge on the CPU, both f32 without TF32: each sums r products in its
# own order (at most r·2^-23·(alpha/r)·Σ_k|A_ik||B_kj| off the exact delta)
# and rounds W + delta once (2^-24·|W + delta| each), so elementwise
# |d| <= 2·r·2^-23·(alpha/r)·Σ_k|A_ik||B_kj| + 2^-23·|W + delta|.
LORA_RANK = 8
LORA_ALPHA = 16.0
LORA_STD = 0.094
LORA_SEED = 0
LORA_TARGETS = ("blocks.attn.wqkv", "blocks.mlp.wi")

# The main paths' sizes: GPT-2-125M at its published widths and window
# (1024), the forward at B=4, training at bench.py's per-device batch of 24.
# A CPU rehearsal (see .claude/skills/verify/SKILL.md) patches these.
DEVICE = "cuda"
PRESET = "gpt2-125m"
SEQ = 1024
SERVE_WINDOW = 1024
FORWARD_B = 4
TRAIN_B = 24
TRAIN_STEPS = 10
DENSE_STEPS = 6
# the flash run's step taken under torch.profiler; the dense run profiles
# its last step. Profiled steps are left out of the median step time.
PROFILE_STEP = 5
# the fwd+bwd sweep: (B, H, Dh) and the sequence lengths
SWEEP_BHD = (4, 12, 64)
SWEEP_LENGTHS = (1024, 2048, 4096)
# the Llama and MoE paths (phases 7-9), at their presets' published widths
LLAMA_INFER = "llama3-8b"
LLAMA_FORWARD_T = 4096
DECODE_B = 4
DECODE_CACHE = 1024
DECODE_PROMPT = 32
DECODE_NEW = 32
LLAMA_TRAIN = "tinyllama-1.1b"
LLAMA_TRAIN_B = 8
LLAMA_TRAIN_T = 2048
LLAMA_TRAIN_STEPS = 10
LLAMA_DENSE_STEPS = 3
LLAMA_PROFILE_STEP = 5
# mixtral-8x7b's 32 layers are 47 B params; two with f32 Adam are ~51 GB
MOE_PRESET = "mixtral-8x7b"
MOE_LAYERS = 2
MOE_B = 2
MOE_T = 2048
MOE_STEPS = 5
# phase_dp, data parallel on torch.distributed: (b) GPT-2-125M at world 1 on
# NCCL in phase 6's configuration for DP_STEPS steps, held bit-equal to the
# one-device step; (c) two ranks sharing the one card over gloo (NCCL
# refuses two ranks on one GPU), DP_RANK_B rows a rank for DP_RANK_STEPS
# steps, f32 and then int8 with error feedback in DP_CHUNK-element blocks.
DP_BACKEND = "nccl"
DP_STEPS = 5
DP_RANK_B = 4
DP_RANK_STEPS = 4
DP_CHUNK = 4096
# (c)'s runs: (label, (inter, intra), int8 with error feedback). Two hosts
# of one rank each put the sum on the inter hop (quantized in the second
# run); one host of two ranks puts it on the intra reduce-scatter and
# all-gather (an inter hop of one member is never quantized).
DP_RANK_RUNS = (("f32", (2, 1), False), ("int8-ef", (2, 1), True),
                ("f32 intra", (1, 2), False))
# (c)'s int8-EF run against one process at the global batch. Steps 0 and 1
# see the init's params in both runs (the first update has lr 0), so their
# grad norms, which the optimizer takes from the synced gradients, differ
# only by what the int8 wire and the residual did to those gradients: half
# a quantum (a chunk's absmax / 254) an element at most, 1.0e-4 and 1.8e-4
# of the norm on the H100. A wrong scale or a lost share of a chunk's
# magnitude moves them by whole percents; the bound is about ten times the
# readings. The losses cannot see such a fault (Adam's first updates are
# close to sign(g)) and move for a reason of their own: gradients that
# round to zero take no Adam step where f32 takes a whole one, so the
# trajectories part from step 2 on (|dloss| 2.16e-4 at step 2, 4.2e-3 at
# step 3; at step 4 lr 6e-4 throws both runs off, f32 too). The loss bound
# holds the run to training as one process does, about five times the step
# 3 reading. f32 runs: TOL_TRAIN_LOSS and TOL_TRAIN_GRAD_NORM on every step.
TOL_DP_INT8_GRAD_NORM = 2e-3
TOL_DP_INT8_LOSS = 2e-2
# a hung rank fails the phase instead of stalling the script
DP_SPAWN_S = 300
# phase_mesh (6c): (a) world 1, MESH_STEPS steps at phase 6's
# configuration; (c) two ranks: GPT-2 at a global batch of MESH_B, the MoE
# at MOE_B x MOE_T with MESH_MOE_LAYERS layer(s) (so that the two ranks and
# the one-process reference fit one card: ~1.0 B params a rank, ~16 GB with
# f32 Adam), each run (label, family, mesh config, steps)
MESH_STEPS = 5
MESH_B = 8
MESH_MOE_LAYERS = 1
MESH_RUNS = (("tp=2", "gpt2", {"tp": 2}, 3),
             ("fsdp=2", "gpt2", {"fsdp": 2}, 3),
             ("ep=2", "moe", {"ep": 2}, 2))
# hier_cards (tests/test_torch_cuda.py::test_mesh_across_cards, four cards
# over NCCL): the hierarchical mesh Topology(2, 1) x tp=2, GPT-2-125M at
# phase 6's configuration and MESH_B, against one process
HIER_TOPOLOGY = (2, 1)
HIER_RUNS = (("Topology(2, 1) x tp=2", "gpt2", {"dp": 2, "tp": 2}, 3),)
# phase_compose (a): the tensor-parallel engine, both shards on the card,
# at phase 5's configuration, against tp=1. The gate, stated before the
# run: every logits row the two engines sample from, up to and including
# the first position where their greedy streams part, within
# TOL_TP_LOGITS (phase 5's bf16 bound: tp=2 adds the row-parallel
# products' partial sums in another order); a stream may part only where
# tp=1's top-2 margin is under the same bound (a near-tie, recorded)
TOL_TP_LOGITS = 0.1
TP_PROMPTS = ((11, 192), (12, 300), (13, 64), (14, 500))   # (seed, length)
TP_NEW = 32
# (b)'s ops: the collective of each redistribution DTensor makes, and the
# redistribution that issues it
GLOO_OPS = {"all_gather": "Shard -> Replicate",
            "reduce_scatter": "Partial -> Shard",
            "all_reduce": "Partial -> Replicate",
            "all_to_all": "Shard(1) -> Shard(0)",
            "scatter": "distribute_tensor"}

# phase_ring: the ring's per-rank schedule (ops.ring_attention's
# generators, the ones the distributed path drives) run for sp virtual
# ranks on the one card with an in-process rotation. (name, B, H, KV heads,
# T, Dh, sp): Llama-3-8B's attention widths at long context, K/V expanded
# 4x from the KV heads as llama.expand_kv does (chunks of 4096), and
# GPT-2-125M's training shape (QKV views, chunks of 512). The first case's
# non-causal chunk pair fills the kernels line's "ring_chunk" records.
# The third case is ragged: chunks of 4000 positions, padded to 4096 on
# each rank with K1's and K2's kv_len masking the padded keys; its
# non-causal chunk pair fills "ring_ragged_chunk".
RING_CASES = (("llama3-8b-long", 1, 32, 8, 16384, 128, 4),
              ("gpt2-125m-train", 24, 12, 12, 1024, 64, 2),
              ("llama3-8b-ragged", 1, 32, 8, 16000, 128, 4))
# phase_checkpoint: phase 6's configuration, CKPT_STEPS steps, then the
# whole TrainState saved and restored gathering and streaming (CKPT_CHUNK
# bytes a chunk)
CKPT_STEPS = 2
CKPT_CHUNK = 64 << 20
# sp_pair (tests/test_torch_cuda.py::test_sp_across_cards, two cards over
# NCCL): (label, family, mesh config, steps, attention) against one process
# on one card at the same global batch (flash); GPT-2-125M at SP_B x SEQ,
# tinyllama-1.1b at SP_LLAMA_B x LLAMA_TRAIN_T. The first run's state is
# saved by both ranks and restored on one card.
SP_B = 8
SP_LLAMA_B = 2
SP_RUNS = (("gpt2 sp=2 ring", "gpt2", {"sp": 2}, 3, "ring"),
           ("gpt2 sp=2 ulysses", "gpt2", {"sp": 2}, 3, "ulysses"),
           ("tinyllama sp=2 ring", "llama", {"sp": 2}, 2, "ring"))

# phase_pipeline: GPT-2-125M at phase 6's configuration (B=TRAIN_B, T=SEQ,
# remat "dots", flash) through compile_pipeline_train on PIPE_F virtual
# stages of one card with PIPE_M microbatches, PIPE_STEPS steps (the last
# one profiled), against compile_model_train on one device from the same
# init and batch
PIPE_F = 4
PIPE_M = 8
PIPE_STEPS = 5
# pp_cards (tests/test_torch_cuda.py::test_pp_across_cards, NCCL, one rank
# a card): (label, family, mesh config, steps, global B, T, microbatches).
# GPT-2-125M at phase 6's configuration on two cards, against one process;
# Llama-3-8B at full width and depth on four, the configuration that needs
# the pipeline (8.03 B params with f32 Adam are ~128 GB of state; a rank
# of pp=4 holds 8 layers and the replicated embedding and head), against
# one card's no-grad loss_fn at the same weights and batch
# TinyLlama-1.1B on pp=2 x sp=2 over four cards (11 layers a stage, the
# ring running K1-K3 on chunk pairs inside every stage), B=4 T=4096 (the
# preset's max_seq_len, 2048 a sp rank) in 4 microbatches, against the
# same model and batch trained on one card (first loss and grad norm)
PP_RUNS = {"gpt2": ("gpt2-125m pp=2", "gpt2", {"pp": 2}, 3, 24, 1024, 8),
           "llama": ("llama3-8b pp=4", "llama", {"pp": 4}, 2, 8, 2048, 8),
           "tinyllama-sp": ("tinyllama-1.1b pp=2 sp=2", "llama",
                            {"pp": 2, "sp": 2}, 2, 4, 4096, 4)}
PP_LLAMA = "llama3-8b"
PP_SPAWN_S = 900

# (name, B, H, T, Dh, dtype, causal, layout). layout "qkv": q, k, v are
# views split from one [B, T, 3*H*Dh] tensor and dO is the transposed view
# of a [B, T, H*Dh] gradient, as gpt2._attention and autograd hand them to
# the kernels; "gqaG": q and dO are transposed views of [B, T, H, Dh]
# tensors and k, v are expanded from H/G KV heads (llama.expand_kv), as
# llama.attention hands them over; "contiguous": all four contiguous. The
# first case is the GPT-2 training main path's own shape and layout (its
# K1, K2, K3 records fill the kernels line); the second is the GPT-2
# forward's; then the Llama paths' (LLAMA_SHAPES), after the earlier cases
# so that those draw the inputs they always drew, and a head dim of 80
# (phi-2's widths), which the wrapper pads to the kernels' 128.
KERNEL_CASES = [
    ("train-path", 24, 12, 1024, 64, torch.bfloat16, True, "qkv"),
    ("forward-path", 4, 12, 1024, 64, torch.bfloat16, True, "qkv"),
    ("b4-t1024", 4, 12, 1024, 64, torch.bfloat16, True, "contiguous"),
    ("b8-t1024", 8, 12, 1024, 64, torch.bfloat16, True, "contiguous"),
    ("b2-t2048", 2, 12, 2048, 64, torch.bfloat16, True, "contiguous"),
    ("non-causal", 4, 12, 1024, 64, torch.bfloat16, False, "contiguous"),
    ("f32", 2, 12, 1024, 64, torch.float32, True, "contiguous"),
    ("dh32", 2, 4, 256, 32, torch.bfloat16, True, "contiguous"),
    ("dh128-f32", 2, 4, 256, 128, torch.float32, False, "contiguous"),
    ("ragged-t100", 4, 12, 100, 64, torch.bfloat16, True, "contiguous"),
    ("dh128", 2, 12, 1024, 128, torch.bfloat16, True, "contiguous"),
    ("dh32-non-causal", 2, 4, 256, 32, torch.bfloat16, False, "contiguous"),
    ("tinyllama-train", 8, 32, 2048, 64, torch.bfloat16, True, "gqa8"),
    ("llama3-8b-forward", 1, 32, 4096, 128, torch.bfloat16, True, "gqa4"),
    ("dh80", 2, 32, 2048, 80, torch.bfloat16, True, "contiguous"),
]
# the Llama paths' kernel cases, reported in the kernels line beside the
# GPT-2 training path's
LLAMA_SHAPES = ("tinyllama-train", "llama3-8b-forward")


def log(msg: str) -> None:
    print(msg, flush=True)


def close(a, b, atol, rtol) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), bool((err <= atol + rtol * b.abs()).all())


# ~0.1 s of the card's clock (about 1.98 GHz under load): long enough for
# the host to enqueue a timed loop behind it
SLEEP_CYCLES = 200_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events), after `warmup` calls. The card runs a sleep kernel while the
    host enqueues the calls, so the host's cost of a call (tenths of a ms
    for one autograd call) is not timed where the card is faster. Inputs
    stay in L2 where they fit, as on the main path, where K1 reads q/k/v
    just written by the QKV product."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _pairs(B, H, Tq, Tk, causal) -> int:
    """(query, key) pairs that the mask keeps."""
    return B * H * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)


def attention_bound(B, H, Tq, Tk, Dh, dtype, causal) -> tuple:
    """K1's (bound_ms, bound_by): the least time for the work the inputs
    need: each of q, k, v read once and O, lse written once; 4*Dh flops per
    kept (query, key) pair (S and P V)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * B * H * Dh * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    return _bound(4.0 * Dh * _pairs(B, H, Tq, Tk, causal), nbytes, dtype)


def dq_bound(B, H, Tq, Tk, Dh, dtype, causal) -> tuple:
    """K2's: q, O, dO, k, v read and dQ written (input type), lse read and
    Delta written (f32); 6*Dh flops per kept pair (S, dP, dS K) and 2*Dh per
    row for Delta = rowsum(dO * O)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * B * H * Dh * (4 * Tq + 2 * Tk) + 8 * B * H * Tq
    flops = 6.0 * Dh * _pairs(B, H, Tq, Tk, causal) + 2.0 * Dh * B * H * Tq
    return _bound(flops, nbytes, dtype)


def dkv_bound(B, H, Tq, Tk, Dh, dtype, causal) -> tuple:
    """K3's: q, dO, k, v read and dK, dV written (input type), lse and Delta
    read (f32); 8*Dh flops per kept pair (S, dP, P^T dO, dS^T Q)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * B * H * Dh * (2 * Tq + 4 * Tk) + 8 * B * H * Tq
    return _bound(8.0 * Dh * _pairs(B, H, Tq, Tk, causal), nbytes, dtype)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phases
# the main paths' K1, K2 and K3 instantiations: they must not spill (Dh=64:
# GPT-2 and tinyllama; Dh=128: llama3-8b's forward and the MoE's training)
MAIN_PATH_MMA = tuple(f"flash_{k}_mma_kernel<bf16, Dh={dh}>"
                      for dh in (64, 128)
                      for k in ("fwd", "bwd_dq", "bwd_dkv"))
# a kernel instantiation's mangled name: the FMA kernels are templates on
# the type and Dh, the tensor-core (mma) ones on Dh alone (bf16)
_KERNEL_NAME = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_mma)?_kernel)I(13__nv_bfloat16|f)?Li(\d+)E")


def _instantiation(line: str):
    """'kernel<dtype, Dh=n>' of the kernel named in a line, or None."""
    m = _KERNEL_NAME.search(line)
    if m is None:
        return None
    kernel, typ, dh = m.groups()
    bf16 = typ == "13__nv_bfloat16" or (typ is None and "_mma" in kernel)
    return f"{kernel}<{'bf16' if bf16 else 'f32'}, Dh={dh}>"


def _ptxas_summary(log_text: str) -> dict:
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} from `ptxas -v`."""
    rows, name, spill = {}, None, None
    for line in log_text.splitlines():
        inst = _instantiation(line)
        if inst and ("Compiling entry" in line or "Function properties" in line):
            name = inst
        elif name and "spill stores" in line:
            spill = tuple(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows[name] = (regs, *spill)
            name = None
    if not rows:
        raise AssertionError("no kernel found in ptxas -v's output:\n" + log_text)
    return rows


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: the tensor-core instruction "
                           "count needs the CUDA toolkit's cuobjdump")
    return found


def _tensor_core_counts(lib: str) -> dict:
    """{kernel instantiation: HMMA/HGMMA instructions} in the SASS of a
    built library (`cuobjdump -sass`)."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = _instantiation(line)
            if name:
                counts[name] = 0
        elif name and re.search(r"\bH(?:G)?MMA\b", line):
            counts[name] += 1
    return counts


def phase_build() -> None:
    """Build every kernel; print registers, spills and tensor-core
    instructions per instantiation. Fails if a bf16 (tensor-core)
    instantiation of K1, K2 or K3 has no tensor-core instruction, or if a
    main path's (bf16, Dh=64 or 128) K1, K2 or K3 spills."""
    t0 = time.perf_counter()
    info = _kernels.build_all()
    log(f"[build] {len(info)} kernel(s) built in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, rec in info.items():
        for inst, (regs, st, ld) in _ptxas_summary(rec["log"]).items():
            log(f"[build] {name}: {inst}: {regs} registers, {st} bytes spill "
                f"stores, {ld} bytes spill loads")
            if inst in MAIN_PATH_MMA and (st or ld):
                raise AssertionError(f"{inst} spills")
        for inst, n in _tensor_core_counts(_kernels._lib_path(name)).items():
            log(f"[build] {name}: {inst}: {n} tensor-core instructions "
                f"(HMMA/HGMMA in its SASS)")
            if "_mma_" in inst and n == 0:  # K1, K2 and K3 in bf16
                raise AssertionError(f"{inst} has no tensor-core instruction")


def _case_inputs(gen, B, H, T, Dh, dtype, layout) -> list:
    """q, k, v, dO [B, H, T, Dh] of a kernel case (see KERNEL_CASES)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    if layout == "contiguous":
        return [randn(B, H, T, Dh) for _ in range(4)]
    if layout.startswith("gqa"):
        G = int(layout[3:])
        q, k, v, do = (randn(B, T, heads, Dh) for heads in (H, H // G,
                                                            H // G, H))
        k, v = llama.expand_kv(k, G), llama.expand_kv(v, G)
        return [t.transpose(1, 2) for t in (q, k, v, do)]
    D = H * Dh
    return [t.reshape(B, T, H, Dh).transpose(1, 2)
            for t in (*randn(B, T, 3 * D).split(D, dim=-1), randn(B, T, D))]


def _case_label(B, H, T, Dh, dtype, causal, layout) -> str:
    if layout.startswith("gqa"):
        G = int(layout[3:])
        layout = f"q views, K/V expanded {G}x from {H // G} KV heads"
    elif layout == "qkv":
        layout = "QKV views"
    return (f"B={B} H={H} T={T} Dh={Dh} {str(dtype)[6:]} causal={causal} "
            f"{layout}")


def phase_kernels(gen: torch.Generator) -> dict:
    """K1 against flash_attention_reference and mha_reference, and the cost
    of the GQA expansion at the Llama shapes; returns {case name: K1's
    record}."""
    recs = {}
    for name, *case in KERNEL_CASES:
        B, H, T, Dh, dtype, causal, _ = case
        q, k, v, _ = _case_inputs(gen, *case[:4], dtype, case[6])
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        mha = fa.mha_reference(q, k, v, causal)
        err_o, ok_o = close(out, ref_out, **TOL_PLAIN[dtype])
        err_l, ok_l = close(lse, ref_lse, **TOL_LSE)
        err_m, ok_m = close(out, mha, **TOL_MHA[dtype])
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 {name}: non-finite output")
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal), iters=5)
        lib_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal))
        bound_ms, bound_by = attention_bound(B, H, T, T, Dh, dtype, causal)
        rec = dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        log(f"[K1 {name}] {_case_label(*case)}: |dO| vs plain {err_o:.3g} "
            f"(tol {TOL_PLAIN[dtype]}), |dlse| {err_l:.3g} (tol {TOL_LSE}), "
            f"|dO| vs mha_reference {err_m:.3g} (tol {TOL_MHA[dtype]}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.2f}% of bound")
        if not (ok_o and ok_l and ok_m):
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        recs[name] = rec
        if case[6].startswith("gqa"):
            _gqa_copy(name, B, H, T, Dh, dtype, int(case[6][3:]), ms)
    return recs


def _gqa_copy(name, B, H, T, Dh, dtype, G, k1_ms) -> None:
    """Time the expansion of K and V from H/G KV heads to H (llama.expand_kv:
    a copy) and its backward (autograd's sum over each group), beside K1 at
    the same shape. Bound: the bytes read and written, over HBM bandwidth."""
    KV = H // G
    k, v = (torch.randn((B, T, KV, Dh), device=DEVICE).to(dtype)
            .requires_grad_() for _ in range(2))
    fwd_ms = time_ms(lambda: (llama.expand_kv(k, G), llama.expand_kv(v, G)))
    big = [llama.expand_kv(t, G) for t in (k, v)]
    grads = [torch.randn_like(t) for t in big]
    bwd_ms = time_ms(lambda: torch.autograd.grad(big, (k, v), grads,
                                                 retain_graph=True))
    esz = big[0].element_size()
    bound = 2 * esz * B * T * Dh * (KV + H) / HBM_BYTES_PER_S * 1e3
    log(f"[gqa copy {name}] K and V [B={B}, T={T}, {KV}, {Dh}] -> [{B}, {T}, "
        f"{H}, {Dh}] {str(dtype)[6:]}: expand {fwd_ms:.4f} ms, backward "
        f"(sum over each group of {G}) {bwd_ms:.4f} ms, bound of either "
        f"{bound:.4f} ms (bytes); K1 at this shape {k1_ms:.4f} ms")


def _grads(fn, inputs, do):
    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, do)


def phase_backward(gen: torch.Generator) -> dict:
    """K2 and K3 against their plain versions, and K1+K2+K3 gradients
    against autograd through mha_reference; returns {case name: (K2's
    record, K3's)}."""
    recs = {}
    for name, *case in KERNEL_CASES:
        B, H, T, Dh, dtype, causal, _ = case
        q, k, v, do = _case_inputs(gen, *case[:4], dtype, case[6])
        scale = 1.0 / math.sqrt(Dh)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        # K2 and K3 have no atomics and a fixed order of sums: a second run
        # on the same inputs gives the same bits
        dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        k2_same = torch.equal(dq, dq2) and torch.equal(delta, delta2)
        k3_same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        bq = bk = fa.DEFAULT_BLOCK_Q
        ref_dq, ref_delta = fa._bwd_dq_reference(q, k, v, out, lse, do,
                                                 causal, scale, bq, bk)
        ref_dk, ref_dv = fa._bwd_dkv_reference(q, k, v, do, lse, ref_delta,
                                               causal, scale, bq, bk)
        tol = TOL_GRAD_PLAIN[dtype]
        e_dq, ok_dq = close(dq, ref_dq, **tol)
        e_dl, ok_dl = close(delta, ref_delta, **TOL_LSE)
        e_dk, ok_dk = close(dk, ref_dk, **tol)
        e_dv, ok_dv = close(dv, ref_dv, **tol)
        got = _grads(lambda *t: fa.flash_attention(*t, causal), (q, k, v), do)
        want = _grads(lambda *t: fa.mha_reference(*t, causal),
                      (q.float(), k.float(), v.float()), do.float())
        mha = [close(g, w, **TOL_GRAD_MHA[dtype]) for g, w in zip(got, want)]
        if not all(torch.isfinite(t).all() for t in (dq, dk, dv)):
            raise AssertionError(f"K2/K3 {name}: non-finite gradients")
        k2_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, causal))
        k3_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        k2_plain = time_ms(lambda: fa._bwd_dq_reference(
            q, k, v, out, lse, do, causal, scale, bq, bk), iters=3)
        k3_plain = time_ms(lambda: fa._bwd_dkv_reference(
            q, k, v, do, lse, delta, causal, scale, bq, bk), iters=3)
        # the library yardstick for K2+K3 together: SDPA's backward alone;
        # its gradients' distance from mha_reference's is printed beside
        # the kernels' (a yardstick for TOL_GRAD_MHA, not a gate)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        lib = torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True)
        lib_err = [close(g, w, 0, 0)[0] for g, w in zip(lib, want)]
        del lib
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), do, retain_graph=True))
        del o
        b2 = dq_bound(B, H, T, T, Dh, dtype, causal)
        b3 = dkv_bound(B, H, T, T, Dh, dtype, causal)
        log(f"[K2/K3 {name}] {_case_label(*case)}: vs plain |ddQ| {e_dq:.3g} |ddK| {e_dk:.3g} "
            f"|ddV| {e_dv:.3g} (tol {tol}), |dDelta| {e_dl:.3g} (tol "
            f"{TOL_LSE}); K1+K2+K3 vs autograd(mha_reference) |d| "
            f"{', '.join(f'{e:.3g}' for e, _ in mha)} (tol "
            f"{TOL_GRAD_MHA[dtype]}), sdpa's "
            f"{', '.join(f'{e:.3g}' for e in lib_err)}; K2 {k2_ms:.4f} ms "
            f"(plain {k2_plain:.4f}, "
            f"bound {b2[0]:.4f} {b2[1]}, {100 * b2[0] / k2_ms:.2f}%), K3 "
            f"{k3_ms:.4f} ms (plain {k3_plain:.4f}, bound {b3[0]:.4f} "
            f"{b3[1]}, {100 * b3[0] / k3_ms:.2f}%), sdpa backward "
            f"{lib_ms:.4f} ms; K2 twice bit-equal: {k2_same}, K3 twice "
            f"bit-equal: {k3_same}")
        if not (ok_dq and ok_dl and ok_dk and ok_dv and all(o for _, o in mha)):
            raise AssertionError(f"K2/K3 {name} disagree with their plain "
                                 f"versions or with mha_reference")
        for kname, same in (("K2", k2_same), ("K3", k3_same)):
            if not same:
                raise AssertionError(f"{kname} {name}: two runs on the same "
                                     f"inputs differ")
        recs[name] = (dict(max_abs_err=max(e_dq, e_dl), ms=k2_ms,
                           plain_ms=k2_plain, bound_ms=b2[0], bound_by=b2[1],
                           library_ms=lib_ms),
                      dict(max_abs_err=max(e_dk, e_dv), ms=k3_ms,
                           plain_ms=k3_plain, bound_ms=b3[0], bound_by=b3[1],
                           library_ms=lib_ms))
    return recs


def phase_sweep(gen: torch.Generator) -> None:
    """Attention forward + backward, bf16 causal: K1+K2+K3 through autograd
    against SDPA (a yardstick the port never calls) and the dense path."""
    B, H, Dh = SWEEP_BHD
    for T in SWEEP_LENGTHS:
        q, k, v, do = _case_inputs(gen, B, H, T, Dh, torch.bfloat16,
                                   "contiguous")
        fns = {
            "flash": lambda *t: fa.flash_attention(*t, True),
            "sdpa": lambda *t: F.scaled_dot_product_attention(
                *t, is_causal=True),
            "dense": lambda *t: gpt2.dense_attention(*t, torch.bfloat16),
        }
        ms = {n: time_ms(lambda: _grads(fn, (q, k, v), do), iters=5,
                         warmup=1) for n, fn in fns.items()}
        bound = sum(f(B, H, T, T, Dh, torch.bfloat16, True)[0]
                    for f in (attention_bound, dq_bound, dkv_bound))
        log(f"[fwd+bwd T={T}] B={B} H={H} Dh={Dh} bf16 causal: flash "
            f"{ms['flash']:.4f} ms, sdpa {ms['sdpa']:.4f} ms, dense "
            f"{ms['dense']:.4f} ms; K1+K2+K3 bounds {bound:.4f} ms")


def phase_forward(gen: torch.Generator) -> None:
    preset, B, T = PRESET, FORWARD_B, SEQ
    cfg = gpt2.GPT2Config.preset(preset, attn_impl="flash")
    params = gpt2.init_params(gen, cfg, DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen
                           ).to(DEVICE)
    before = fa.flash_attention.launches
    logits = gpt2.forward(params, tokens[:, :T], cfg)
    torch.cuda.synchronize()
    per_forward = fa.flash_attention.launches - before
    if per_forward != cfg.n_layer:
        raise AssertionError(f"{per_forward} K1 launches in one forward, "
                             f"want {cfg.n_layer}")
    dense_cfg = gpt2.GPT2Config.preset(preset, attn_impl="dense")
    dense = gpt2.forward(params, tokens[:, :T], dense_cfg)
    err, _ = close(logits, dense, TOL_LOGITS, 0.0)
    loss = float(gpt2.loss_fn(params, {"tokens": tokens}, cfg))
    ms = time_ms(lambda: gpt2.forward(params, tokens[:, :T], cfg), iters=5,
                 warmup=1)
    dense_ms = time_ms(lambda: gpt2.forward(params, tokens[:, :T], dense_cfg),
                       iters=5, warmup=1)
    log(f"[forward {preset}] B={B} T={T} bf16: {per_forward} K1 launches "
        f"per forward; logits {tuple(logits.shape)} flash vs dense max "
        f"|d| {err:.4g} (tol {TOL_LOGITS}); loss {loss:.4f} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); forward {ms:.3f} ms "
        f"flash, {dense_ms:.3f} ms dense")
    if not torch.isfinite(logits.float()).all() or err > TOL_LOGITS:
        raise AssertionError("flash forward disagrees with dense forward")
    if not (math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1):
        raise AssertionError(f"loss {loss} not near ln(vocab)")


def _prompt(seed: int, n: int, prefix=()) -> list:
    g = torch.Generator().manual_seed(seed)
    tail = torch.randint(1, 257, (n - len(prefix),), generator=g).tolist()
    return list(prefix) + tail


def _first_token_logits(eng, prompt: list) -> tuple:
    """The first generated token's logits two ways: the engine's chunked
    prefill (dense cache attention) vs `gpt2.forward`'s last position (the
    flash kernel K1 where len(prompt) % 128 == 0). (max |d|, argmax)."""
    device, B = eng.device, eng.max_batch
    with torch.inference_mode():
        ids = torch.tensor([prompt], device=device)
        fwd_last = gpt2.forward(eng.params, ids, eng.cfg)[0, -1].float()
        cache = gpt2.init_cache(eng.cfg, B, eng.max_seq_len, device=device)
        C = eng.prefill_chunk_size
        for p0 in range(0, len(prompt), C):
            n = min(C, len(prompt) - p0)
            toks = torch.zeros((B, C), dtype=torch.long, device=device)
            toks[0, :n] = ids[0, p0:p0 + n]
            lanes = torch.zeros((B,), dtype=torch.long, device=device)
            lanes[0] = n
            pos0 = torch.zeros((B,), dtype=torch.long, device=device)
            pos0[0] = p0
            logits, cache = gpt2.prefill_chunk(
                eng.params, cache, toks, pos0, lanes, lanes > 0, eng.cfg)
    return (float((logits[0] - fwd_last).abs().max()),
            int(logits[0].argmax()))


def phase_serve(card: str) -> None:
    preset, window, device = PRESET, SERVE_WINDOW, DEVICE
    server = LLMServer(preset=preset, max_batch=4, max_seq_len=window,
                       seed=0, prefill_chunk_size=64, kv_block_size=16,
                       kv_blocks=64, device=device)
    eng = server.engine
    plain = None
    try:
        shared = _prompt(1, 192)
        a = _prompt(2, 256, shared)          # T % 128 == 0: forward -> K1
        b = _prompt(3, 300, shared)
        others = [_prompt(4, 90), _prompt(5, 40), _prompt(6, 500),
                  _prompt(7, 12), _prompt(8, 130)]
        server({"prompt_ids": [1, 2, 3], "max_tokens": 4})   # warm-up
        out_a = server({"prompt_ids": a, "max_tokens": 32})
        tok_a = out_a["choices"][0]["token_ids"]

        # six requests at once: B shares A's prefix; several prompts are
        # longer than the 64-token prefill chunk
        batch = [b] + others
        results = [None] * len(batch)
        ttft0 = (eng.ttft_sum, eng.ttft_count)

        def call(j):
            results[j] = server({"prompt_ids": batch[j], "max_tokens": 64})

        threads = [threading.Thread(target=call, args=(j,))
                   for j in range(len(batch))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        if any(r is None for r in results):
            raise AssertionError("a request got no answer")
        n_tok = sum(len(r["choices"][0]["token_ids"]) for r in results)
        ttft = ((eng.ttft_sum - ttft0[0]) / (eng.ttft_count - ttft0[1]))
        stats = server.stats()
        if stats["kv_cache"]["prefix_hits"] < 1:
            raise AssertionError(f"no prefix hit: {stats['kv_cache']}")
        if stats["chunk_steps"] < 1:
            raise AssertionError("chunked prefill never ran")

        # greedy with prefix reuse == greedy without (solo runs)
        cached_b = server({"prompt_ids": b, "max_tokens": 32})
        plain = LLMEngine(preset=preset, max_batch=4, max_seq_len=window,
                          params_override=eng.params, cfg_override=eng.cfg,
                          enable_prefix_caching=False, prefill_chunk_size=64,
                          device=device)
        plain_b = plain.generate(prompt_ids=b, max_tokens=32)["token_ids"]
        plain_a = plain.generate(prompt_ids=a, max_tokens=32)["token_ids"]
        same = (cached_b["choices"][0]["token_ids"] == plain_b
                and tok_a == plain_a)

        first_err, first_tok = _first_token_logits(eng, a)
        log(f"[serve {preset}] max_batch=4 window={window} chunk=64: "
            f"{len(batch)} concurrent requests, {n_tok} tokens in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tok/s, mean TTFT "
            f"{ttft * 1e3:.1f} ms on {card}; kv {stats['kv_cache']}; "
            f"chunk_steps {stats['chunk_steps']}; greedy with == without "
            f"prefix reuse: {same}; first-token logits prefill vs forward "
            f"max |d| {first_err:.4g} (tol {TOL_LOGITS}), argmax "
            f"{first_tok} vs served {tok_a[0]}")
        if not same:
            raise AssertionError("prefix reuse changed greedy output")
        if first_err > TOL_LOGITS or first_tok != tok_a[0]:
            raise AssertionError("first-token logits disagree with forward")
        server.check_health()
    finally:
        server.shutdown()
        if plain is not None:
            plain.shutdown()


def _write_adapters(root: str, cfg, names) -> None:
    import numpy as np

    rng = np.random.default_rng(LORA_SEED)
    L, D, r = cfg.n_layer, cfg.d_model, LORA_RANK
    width = {"blocks.attn.wqkv": 3 * cfg.d_model, "blocks.mlp.wi": cfg.d_ff}
    for name in names:
        arrays = {}
        for path in LORA_TARGETS:
            arrays[f"{path}.A"] = LORA_STD * rng.standard_normal(
                (L, D, r), dtype=np.float32)
            arrays[f"{path}.B"] = LORA_STD * rng.standard_normal(
                (L, r, width[path]), dtype=np.float32)
            arrays[f"{path}.alpha"] = np.float32(LORA_ALPHA)
        np.savez(os.path.join(root, f"{name}.npz"), **arrays)


def _leaf(params, path: str):
    for key in path.split("."):
        params = params[key]
    return params


def _merge_gap(eng, base, adapter: dict) -> tuple:
    """An adapter engine's merged leaves (merged on its device) against the
    same merge on the CPU: (max |d|, largest |d| / bound, within bound)."""
    sub: dict = {}
    for path in adapter:
        *parents, last = path.split(".")
        node = sub
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = _leaf(base.params, path).cpu()
    ref = gpt2.apply_lora(sub, adapter)
    worst, ratio, ok = 0.0, 0.0, True
    for path, spec in adapter.items():
        want, got = _leaf(ref, path), _leaf(eng.params, path).cpu()
        A = torch.from_numpy(spec["A"]).abs()
        B = torch.from_numpy(spec["B"]).abs()
        r = A.shape[-1]
        alpha = float(spec.get("alpha", r))
        bound = (2 * r * 2.0 ** -23 * (alpha / r) * (A @ B)
                 + 2.0 ** -23 * want.abs())
        d = (got - want).abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / bound.clamp_min(1e-30)).max()))
        ok = ok and bool((d <= bound).all())
    return worst, ratio, ok


def _own_bytes(eng, base, params_only: bool = False) -> int:
    """Bytes of the tensors `eng` holds that `base` does not share: its
    merged params and, unless params_only, its KV cache and prefix pool."""
    shared = {t.data_ptr() for t in gpt2._flatten(base.params).values()}
    held = [t for t in gpt2._flatten(eng.params).values()
            if t.data_ptr() not in shared]
    if not params_only:
        held += [eng.cache["k"], eng.cache["v"]]
        if eng.kv is not None:
            held += [eng.kv.pool_k, eng.kv.pool_v]
    return sum(t.numel() * t.element_size() for t in held)


def _stream(server, path: str, body: dict) -> tuple:
    """A `stream: true` request polled with stream_next to the end:
    (token ids, text)."""
    mark = server(types.SimpleNamespace(path=path,
                                        json={**body, "stream": True}))
    sid = mark["__sse_stream__"]["stream_id"]
    toks, text, cursor = [], "", 0
    deadline = time.time() + 120
    while time.time() < deadline:
        part = server.stream_next(sid, cursor)
        if part.get("error"):
            raise AssertionError(f"stream failed: {part['error']}")
        toks += part["token_ids"]
        text += part["text"]
        cursor = part["cursor"]
        if part["done"]:
            return toks, text
    raise TimeoutError("stream did not finish in 120 s")


def phase_openai(card: str) -> None:
    """The OpenAI-compatible server at full width with three LoRA adapters
    (max_loras=2): adapter tenants, the merge on the card, the adapter's
    first-token logits against forward (K1), a batch_call burst, chat
    streaming, and KV export/import with deferred admission."""
    preset, window, device = PRESET, SERVE_WINDOW, DEVICE
    names = ("ad0", "ad1", "ad2")
    mid = "gpt2"
    root = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    srv = decode = cold = None
    try:
        srv = OpenAIServer(model_id=mid, preset=preset, max_batch=4,
                           max_seq_len=window, seed=0, prefill_chunk_size=64,
                           lora_root=root, max_loras=2, device=device)
        base = srv.engine
        _write_adapters(root, base.cfg, names)
        completion = "/v1/completions"
        body = {"prompt_ids": _prompt(20, 64), "max_tokens": 16,
                "temperature": 0.0}

        # 1. adapters: each moves greedy output, the base's stays put
        base_toks, _ = _stream(srv, completion, body)
        build_ms, toks = {}, {}

        def load(name):
            t0 = time.perf_counter()
            eng = srv._engine_for({"model": f"{mid}:{name}"})
            build_ms[name] = (time.perf_counter() - t0) * 1e3
            toks[name], _ = _stream(srv, completion,
                                    {**body, "model": f"{mid}:{name}"})
            return eng

        eng0 = load(names[0])
        # 3. the adapter's first-token logits: prefill vs forward (K1)
        long_prompt = _prompt(21, 256)
        served, _ = _stream(srv, completion, {
            "prompt_ids": long_prompt, "max_tokens": 2, "temperature": 0.0,
            "model": f"{mid}:{names[0]}"})
        first_err, first_tok = _first_token_logits(eng0, long_prompt)
        # 2. the merge on the card vs on the CPU
        adapter0 = gpt2.load_lora_npz(os.path.join(root, f"{names[0]}.npz"))
        merge_d, merge_ratio, merge_ok = _merge_gap(eng0, base, adapter0)
        load(names[1])
        base_again, _ = _stream(srv, completion, body)

        # the third adapter evicts the least recently used one (ad0)
        evicted_bytes = _own_bytes(eng0, base, params_only=True)
        evicted_thread, evicted_ref = eng0._thread, weakref.ref(eng0)
        del eng0
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng2 = load(names[2])
        gc.collect()
        torch.cuda.synchronize()
        freed = before + _own_bytes(eng2, base) - \
            torch.cuda.memory_allocated()
        del eng2
        models = [m["id"] for m in srv(types.SimpleNamespace(
            path="/v1/models", json=None))["data"]]
        log(f"[openai {preset}] adapters rank {LORA_RANK} on "
            f"{', '.join(LORA_TARGETS)}: base {base_toks[:6]}..., "
            + ", ".join(f"{n} {toks[n][:6]}..." for n in names)
            + f"; base after loads equal: {base_again == base_toks}; "
            f"models {models}; evicted {names[0]}: thread alive "
            f"{evicted_thread.is_alive()}, engine collected "
            f"{evicted_ref() is None}, memory freed {freed / 1e6:.1f} MB "
            f"(its merged params {evicted_bytes / 1e6:.1f} MB); LoRA engine "
            "build (load, merge, engine start) "
            + ", ".join(f"{build_ms[n]:.1f}" for n in names)
            + f" ms on {card}")
        log(f"[openai {preset}] merge on the card vs the CPU: max |d| "
            f"{merge_d:.4g}, largest |d|/bound {merge_ratio:.4g} on {card}; "
            f"{names[0]} first-token logits prefill vs forward max |d| "
            f"{first_err:.4g} (tol {TOL_LOGITS}), argmax {first_tok} vs "
            f"served {served[0]}")
        if any(toks[n] == base_toks for n in names):
            raise AssertionError("an adapter left greedy output unchanged")
        if base_again != base_toks:
            raise AssertionError("loading adapters changed the base output")
        if (srv.loaded_lora_ids() != list(names[1:])
                or models != [mid] + [f"{mid}:{n}" for n in names[1:]]):
            raise AssertionError(f"LRU or /v1/models wrong: {models}")
        if evicted_thread.is_alive() or evicted_ref() is not None:
            raise AssertionError("the evicted adapter engine lives on")
        if freed < evicted_bytes:
            raise AssertionError(f"eviction freed {freed} bytes, less than "
                                 f"the engine's {evicted_bytes}")
        if not merge_ok:
            raise AssertionError("the merge on the card is past its bound")
        if not first_err <= TOL_LOGITS or first_tok != served[0]:
            raise AssertionError("adapter first-token logits disagree with "
                                 "forward")

        # 4. batch_call: eight requests at once, one malformed
        reqs = [{"prompt_ids": _prompt(30 + j, n), "max_tokens": 24,
                 "temperature": 0.0}
                for j, n in enumerate((40, 300, 90, 12, 500, 130))]
        reqs.insert(3, {"prompt_ids": _prompt(40, 20), "max_tokens": "x"})
        reqs.append({"prompt_ids": _prompt(41, 64), "max_tokens": 24,
                     "temperature": 0.0, "model": f"{mid}:{names[2]}"})
        engines = [base, srv._lora_engines[names[2]]]
        steps0 = sum(e.engine_steps for e in engines)
        ttft0 = [(e.ttft_sum, e.ttft_count) for e in engines]
        t0 = time.perf_counter()
        answers = srv.batch_call(reqs)
        wall = time.perf_counter() - t0
        steps = sum(e.engine_steps for e in engines) - steps0
        ttft = (sum(e.ttft_sum - t[0] for e, t in zip(engines, ttft0))
                / sum(e.ttft_count - t[1] for e, t in zip(engines, ttft0)))
        errors = [j for j, a in enumerate(answers) if CHAIN_ERR in a]
        n_tok = sum(a["usage"]["completion_tokens"] for a in answers
                    if CHAIN_ERR not in a)
        log(f"[openai {preset}] batch_call of {len(reqs)}: error markers "
            f"at {errors}; {n_tok} tokens in {steps} engine steps, "
            f"{wall:.3f} s = {n_tok / wall:.1f} tok/s, mean TTFT "
            f"{ttft * 1e3:.1f} ms on {card}")
        if len(answers) != len(reqs) or errors != [3]:
            raise AssertionError("batch_call lost order or isolation")
        if not steps < n_tok:
            raise AssertionError("batch_call items did not share steps")

        # 5. chat streaming against the same chat without streaming
        msgs = [{"role": "system", "content": "You are terse."},
                {"role": "user", "content": "Name three colours."}]
        chat = {"messages": msgs, "max_tokens": 16, "temperature": 0.0}
        chat_path = "/v1/chat/completions"
        st_toks, st_text = _stream(srv, chat_path, chat)
        plain = srv(types.SimpleNamespace(path=chat_path, json=chat))
        prompt = "".join(f"<|{m['role']}|>{m['content']}" for m in msgs) \
            + "<|assistant|>"
        direct = base.generate(prompt, max_tokens=16)
        log(f"[openai {preset}] chat stream {len(st_toks)} tokens, equal "
            f"to the request without streaming: "
            f"{st_toks == direct['token_ids']}")
        if (st_toks != direct["token_ids"]
                or st_text != plain["choices"][0]["message"]["content"]
                or plain["usage"]["prompt_tokens"]
                != direct["prompt_tokens"]):
            raise AssertionError("streamed chat differs from the request "
                                 "without streaming")

        # 6. KV export/import between engines, and deferred admission
        same = dict(preset=preset, max_batch=4, max_seq_len=window,
                    params_override=base.params, cfg_override=base.cfg,
                    weights_id=base.weights_id, prefill_chunk_size=64,
                    device=device)
        decode = LLMEngine(**same)
        cold = LLMEngine(enable_prefix_caching=False, **same)
        p300 = _prompt(50, 300)
        want = cold.generate(prompt_ids=p300, max_tokens=16)["token_ids"]
        base.generate(prompt_ids=p300, max_tokens=1)      # pools its blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = base.export_prefix(prompt_ids=p300)
        export_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        installed = decode.import_prefix(blob)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        blob_mb = (blob["k"].nbytes + blob["v"].nbytes) / 1e6
        got = decode.generate(prompt_ids=p300, max_tokens=16)["token_ids"]
        reused = decode.kv.stats()["tokens_reused"]

        p2, p3 = _prompt(51, 200), _prompt(52, 150)
        blob2 = base.export_prefix(prompt_ids=p2)
        want2 = cold.generate(prompt_ids=p2, max_tokens=16)["token_ids"]
        want3 = cold.generate(prompt_ids=p3, max_tokens=16)["token_ids"]
        st0 = decode.engine_stats()
        fut = Future()
        timer = threading.Timer(0.2, fut.set_result, [blob2])
        timer.start()
        got2 = decode.generate(prompt_ids=p2, max_tokens=16,
                               prefix_future=fut, prefix_wait_s=30)
        timer.join(10)
        got3 = decode.generate(prompt_ids=p3, max_tokens=16,
                               prefix_future=Future(), prefix_wait_s=0.2)
        st1 = decode.engine_stats()
        imports = st1["prefix_imports"] - st0["prefix_imports"]
        timeouts = st1["prefix_wait_timeouts"] - st0["prefix_wait_timeouts"]
        log(f"[openai {preset}] KV transfer of a 300-token prompt: "
            f"{len(blob['ids'])} tokens in {installed} blocks, blob "
            f"{blob_mb:.3f} MB, export {export_ms:.3f} ms, import "
            f"{import_ms:.3f} ms on {card}; decode equal to a cold engine: "
            f"{got == want} (tokens reused {reused}); deferred import "
            f"+{imports} equal: {got2['token_ids'] == want2}; wait timeout "
            f"+{timeouts} equal: {got3['token_ids'] == want3}")
        if got != want or reused <= 0 or installed != len(blob["ids"]) // 16:
            raise AssertionError("imported KV changed the greedy output")
        if imports != 1 or got2["token_ids"] != want2:
            raise AssertionError("deferred admission went wrong")
        if timeouts != 1 or got3["token_ids"] != want3:
            raise AssertionError("the prefix wait deadline went wrong")
        srv.check_health()
    finally:
        for eng in (decode, cold):
            if eng is not None:
                eng.shutdown()
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def _flash_counts() -> tuple:
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def _zero_counts() -> None:
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0


def _kernel_group(name: str) -> str:
    for key, group in (("flash_fwd_", "K1"), ("flash_bwd_dq_", "K2"),
                       ("flash_bwd_dkv_", "K3")):
        if key in name:
            return group
    low = name.lower()
    # cuBLAS names its kernels gemm/gemv/xmma/cutlass, or nvjet (CUDA 12.8+)
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "matmul"
    return "other"


def _profiled(fn) -> tuple:
    """fn() under torch.profiler: (its result, {kernel group: device ms},
    [(device ms, kernel name)] of its six costliest kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    groups, kernels = collections.Counter(), []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3
            groups[_kernel_group(e.key)] += ms
            kernels.append((ms, e.key))
    return out, groups, sorted(kernels, reverse=True)[:6]


def _train_run(cfg, opt, batch, steps, profile_at, model=gpt2,
               init_device="cpu", on_step=None) -> tuple:
    """`steps` steps of `model` through compile_model_train from params
    drawn by a generator on `init_device` seeded 0: ([(loss, grad_norm)],
    [step s], and the profile of step `profile_at`, as `_profiled` gives
    it). on_step(i, state), where given, runs before step i."""
    train = spmd.compile_model_train(model, cfg, optimizer=opt, device=DEVICE)
    state = train.init_fn(torch.Generator(device=init_device).manual_seed(0))
    hist, secs, profile = [], [], None
    for i in range(steps):
        if on_step is not None:
            on_step(i, state)
        t0 = time.perf_counter()
        if i == profile_at:
            (state, m), *profile = _profiled(
                lambda: train.step_fn(state, batch))
        else:
            state, m = train.step_fn(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))  # syncs
        secs.append(time.perf_counter() - t0)
    return hist, secs, profile


def _step_ms(secs, profile_at) -> float:
    """Median wall time of the steps from the third on, the profiled step
    left out (the profiler slows the host)."""
    return 1e3 * statistics.median(
        s for i, s in enumerate(secs) if i >= 2 and i != profile_at)


def _profile_text(profile, step_ms) -> str:
    """A profiled step's kernel time by group, set against the median
    unprofiled step: the profiled step's own wall time is no measure of
    idleness."""
    groups, top = profile
    busy = sum(groups.values())
    if not busy:
        return "the profiler saw no device time: not measured"
    return (f"kernels {busy:.2f} ms, {100 * busy / step_ms:.1f}% of the "
            f"median step ({step_ms:.2f} ms): "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.most_common())
            + "; costliest: " + "; ".join(f"{ms:.2f} {name[:60]}"
                                          for ms, name in top))


def _log_profile(label, profile, profile_at, secs, preset=None) -> None:
    log(f"[train {preset or PRESET}] {label} step {profile_at + 1} under "
        f"torch.profiler (wall {secs[profile_at] * 1e3:.2f} ms with the "
        f"profiler): " + _profile_text(profile, _step_ms(secs, profile_at)))


def phase_train(card: str) -> tuple:
    """GPT-2 training through compile_gpt2_train with bench.py's defaults,
    flash attention, then the dense path from the same params. The flash
    run is the training main path: launch counts start at 0 and must be
    exactly TRAIN_STEPS times the per-step counts. Returns those counts."""
    preset, B, T, steps = PRESET, TRAIN_B, SEQ, TRAIN_STEPS
    cfg = gpt2.GPT2Config.preset(preset, attn_impl="flash", remat=True,
                                 remat_policy="dots", ce_chunk=0)
    opt = spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(DEVICE)}
    # per step: K1 in each layer's forward and again in its recompute
    # under remat; K2 and K3 once in each layer's backward
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    hist, secs, profile = _train_run(cfg, opt, batch, steps, PROFILE_STEP)
    launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    dense_profile_at = DENSE_STEPS - 1
    dhist, dsecs, dprofile = _train_run(dense_cfg, opt, batch, DENSE_STEPS,
                                        dense_profile_at)
    if _flash_counts() != launches:
        raise AssertionError("the dense training path launched a flash "
                             "kernel")

    fpt = gpt2.flops_per_token(cfg, T)
    rate = {"flash": _train_rates(secs, PROFILE_STEP, fpt, B * T),
            "dense": _train_rates(dsecs, dense_profile_at, fpt, B * T)}
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(hist[:3], dhist[:3]))
    d_norm = max(abs(a[1] / b[1] - 1) for a, b in zip(hist[:3], dhist[:3]))
    log(f"[train {preset}] B={B} T={T} bf16 remat=dots "
        f"{cfg.n_layer} layers: flash launches K1/K2/K3 {launches} over "
        f"{steps} steps (want {per_step} per step); loss "
        f"{' '.join(f'{l:.4f}' for l, _ in hist)}; grad_norm "
        f"{' '.join(f'{g:.4f}' for _, g in hist)}; dense loss "
        f"{' '.join(f'{l:.4f}' for l, _ in dhist)}, grad_norm "
        f"{' '.join(f'{g:.4f}' for _, g in dhist)}; first 3 steps flash vs "
        f"dense max |dloss| {d_loss:.3g} (tol {TOL_TRAIN_LOSS}), max "
        f"|dgrad_norm|/grad_norm {d_norm:.3g} (tol {TOL_TRAIN_GRAD_NORM}); "
        f"peak memory {peak_gb:.2f} GB (flash)")
    _log_profile("flash", profile, PROFILE_STEP, secs)
    _log_profile("dense", dprofile, dense_profile_at, dsecs)
    for name, (ms, tps, mfu) in rate.items():
        log(f"[train {preset}] {name}: step {ms:.2f} ms (median of steps "
            f"3+, the profiled one left out), {tps:.0f} tokens/s, MFU "
            f"{mfu:.2f}% of 989 TFLOP/s bf16 ({fpt:.4g} FLOP/token) on {card}")
    if launches != tuple(steps * n for n in per_step):
        raise AssertionError(f"K1/K2/K3 launches {launches} != {steps} x "
                             f"{per_step}")
    if not all(math.isfinite(x) for h in hist + dhist for x in h):
        raise AssertionError("non-finite loss or grad norm")
    if not hist[-1][0] < hist[0][0] - 0.05:
        raise AssertionError(f"loss did not fall: {hist[0][0]} -> "
                             f"{hist[-1][0]}")
    if d_loss > TOL_TRAIN_LOSS or d_norm > TOL_TRAIN_GRAD_NORM:
        raise AssertionError("flash and dense training disagree")
    return launches


def _dp_cfg(preset):
    return gpt2.GPT2Config.preset(preset, attn_impl="flash", remat=True,
                                  remat_policy="dots", ce_chunk=0)


def _dp_opt():
    return spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)


def _dp_tokens(cfg, B, T):
    return torch.randint(0, cfg.vocab_size, (B, T + 1),
                         generator=torch.Generator().manual_seed(1))


def _dp_nccl_ops(tmp: str) -> None:
    """(a) every op of the module API on CUDA tensors through a world-1
    NCCL group, each result checked."""
    if not dist.is_nccl_available():
        raise AssertionError("this torch has no NCCL")
    col.init_collective_group(1, 0, "nccl", "smoke",
                              store=f"file://{tmp}/nccl-api")
    try:
        x = torch.arange(1, 9, dtype=torch.float32, device=DEVICE)
        got = {f"allreduce {op.name}": col.allreduce(x.clone(), op, "smoke")
               for op in col.ReduceOp}
        got["broadcast"] = col.broadcast(x.clone(), 0, "smoke")
        got["allgather"] = col.allgather(None, x, "smoke")[0]
        got["reducescatter"] = col.reducescatter(x.view(1, 8),
                                                 group_name="smoke")
        col.barrier("smoke")
        got["allreduce_device"] = col.get_group("smoke").allreduce_device(
            x, average=True)
        bad = [k for k, t in got.items()
               if not (t.is_cuda and torch.equal(t, x))]
    finally:
        col.destroy_collective_group("smoke")
    log(f"[dp nccl] world 1: {', '.join(got)} and barrier on CUDA tensors: "
        f"{'all equal to the input' if not bad else 'WRONG: ' + str(bad)}")
    if bad:
        raise AssertionError(f"NCCL world-1 ops wrong: {bad}")


def _dp_quantize(card: str) -> None:
    """(a) the quantizer on the card against the CPU, at GPT-2-125M's
    gradient size padded to whole chunks, int8 and fp8."""
    n = gpt2.num_params(_dp_cfg(PRESET))
    for dtype in ("int8", "float8_e4m3fn"):
        q = QuantizedAllreduce(dtype=dtype, chunk=DP_CHUNK)
        x = torch.randn(q.padded_size(n),
                        generator=torch.Generator().manual_seed(3)) * 1e-3
        want_q, want_s = q.quantize(x)
        xd = x.to(DEVICE)
        got_q, got_s = q.quantize(xd)
        equal = (torch.equal(got_q.cpu().view(torch.uint8),
                             want_q.view(torch.uint8))
                 and torch.equal(got_s.cpu(), want_s))
        ms = time_ms(lambda: q.quantize(xd), iters=10)
        log(f"[dp quantize] {dtype} chunk {DP_CHUNK} of {x.numel()} f32 "
            f"({n} gradients padded): card vs CPU q and scales "
            f"{'bit-equal' if equal else 'DIFFER'}; {ms:.4f} ms a call on "
            f"{card}")
        if not equal:
            raise AssertionError(f"{dtype} quantize on the card differs "
                                 f"from the CPU")
        del x, xd, want_q, got_q


def _one_vs_mesh(cfg, mesh, batch, steps) -> tuple:
    """`steps` GPT-2 steps on one device, then on `mesh`, from the same init
    and batch: ({"one device" | "mesh": (losses, step seconds, params)},
    the mesh run's K1/K2/K3 launches, counted from 0)."""
    runs = {}
    for name, m in (("one device", None), ("mesh", mesh)):
        train = spmd.compile_gpt2_train(cfg, mesh=m, optimizer=_dp_opt(),
                                        device=DEVICE)
        state = train.init_fn(torch.Generator().manual_seed(0))
        if m is not None:
            _zero_counts()
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, met = train.step_fn(state, batch)
            losses.append(float(met["loss"]))   # syncs
            secs.append(time.perf_counter() - t0)
        runs[name] = (losses, secs, state.params)
    return runs, _flash_counts()


def _dp_world1(card: str, tmp: str) -> tuple:
    """(b) GPT-2-125M through a world-1 hierarchical mesh (NCCL) against the
    one-device step from the same init and batch: losses and params
    bit-equal. The data-parallel run is the path whose launches count."""
    dev_id = {"device_id": torch.device(DEVICE, torch.cuda.current_device())
              } if DP_BACKEND == "nccl" else {}
    dist.init_process_group(DP_BACKEND, store=dist.FileStore(
        os.path.join(tmp, "world1"), 1), rank=0, world_size=1, **dev_id)
    try:
        mesh = build_hierarchical_mesh(topology=Topology(1, 1),
                                       device_type=DEVICE)
        cfg = _dp_cfg(PRESET)
        batch = {"tokens": _dp_tokens(cfg, TRAIN_B, SEQ).to(DEVICE)}
        staged = HOST_STAGED["bytes"]
        runs, launches = _one_vs_mesh(cfg, mesh, batch, DP_STEPS)
        staged = HOST_STAGED["bytes"] - staged
        (l1, s1, p1), (l2, s2, p2) = runs["one device"], runs["mesh"]
        same = l1 == l2 and all(torch.equal(a, b) for a, b in
                                zip(spmd._leaves(p1), spmd._leaves(p2)))
        vec = torch.cat([p.reshape(-1) for p in spmd._leaves(p1)])
        groups = hier_groups(mesh)
        sync_ms = time_ms(lambda: hier_grad_sync(vec, groups) / 1, iters=10)
        per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
        log(f"[dp world 1] {PRESET} B={TRAIN_B} T={SEQ} remat=dots on "
            f"{DP_BACKEND}, Topology(1, 1), {DP_STEPS} steps: losses "
            f"{' '.join(f'{v:.6f}' for v in l2)}; one device "
            f"{' '.join(f'{v:.6f}' for v in l1)}; losses and params "
            f"{'bit-equal' if same else 'DIFFER'}; K1/K2/K3 launches "
            f"{launches} (want {per_step} a step); bytes through the host "
            f"{staged}; step {1e3 * statistics.median(s2[2:]):.2f} ms (one "
            f"device {1e3 * statistics.median(s1[2:]):.2f} ms, medians of "
            f"steps 3+); the sync alone (hier_grad_sync of a "
            f"{vec.numel()}-element f32 bucket: the world-1 allreduce and "
            f"the divide) {sync_ms:.4f} ms on {card}")
        if not same:
            raise AssertionError("world-1 data parallel differs from one "
                                 "device")
        if launches != tuple(DP_STEPS * k for k in per_step):
            raise AssertionError(f"K1/K2/K3 launches {launches} != "
                                 f"{DP_STEPS} x {per_step}")
        if DP_BACKEND == "nccl" and staged:
            raise AssertionError(f"NCCL moved {staged} bytes through the "
                                 f"host")
        return launches
    finally:
        dist.destroy_process_group()


def _dp_rank(rank: int, world: int, tmp: str, conf: dict) -> None:
    """(c) one of two ranks sharing the card over gloo, through the runs of
    DP_RANK_RUNS; after every step the ranks' params are compared bit for
    bit (rank 0's broadcast); then the sync alone is timed."""
    device = conf["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "gloo2"), world), rank=rank, world_size=world)
    cfg = _dp_cfg(conf["preset"])
    batch = {"tokens": _dp_tokens(cfg, conf["rank_b"] * world,
                                  conf["seq"]).to(device)}
    out = {}
    for mode, shape, int8 in DP_RANK_RUNS:
        topo = Topology(*shape)
        mesh = build_hierarchical_mesh(topology=topo, device_type=device)
        q = (QuantizedAllreduce(dtype="int8", chunk=conf["chunk"]) if int8
             else None)
        train = spmd.compile_gpt2_train(cfg, mesh=mesh, optimizer=_dp_opt(),
                                        device=device, grad_quantize=q)
        state = train.init_fn(torch.Generator().manual_seed(0))
        ef = train.init_ef_fn() if q is not None else None
        losses, norms, same = [], [], []
        for _ in range(conf["steps"]):
            if ef is None:
                state, met = train.step_fn(state, batch)
            else:
                state, met, ef = train.step_fn(state, batch, ef)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            flat = torch.cat([p.reshape(-1) for p in
                              spmd._leaves(state.params)]).cpu()
            ref = flat.clone()
            dist.broadcast(ref, 0)
            same.append(torch.equal(flat, ref))
        # the sync alone on a bucket of this size, through the host
        n = flat.numel()
        per_shard = -(-n // topo.intra)
        if q is not None:
            per_shard = q.padded_size(per_shard)
        vec = torch.zeros(per_shard * topo.intra, device=device)
        vec[:n] = flat.to(device)
        extra = ({} if q is None else
                 {"residual": torch.zeros(per_shard, device=device)})
        groups = hier_groups(mesh)
        hier_grad_sync(vec, groups, q, **extra)   # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            hier_grad_sync(vec, groups, q, **extra)
        if device == "cuda":
            torch.cuda.synchronize()
        out[mode] = (losses, norms, same,
                     (time.perf_counter() - t0) / 3 * 1e3)
        del train, state, ef, flat, ref, vec
        if device == "cuda":
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"dp-rank{rank}.pt"))
    dist.destroy_process_group()


def _dp_two_ranks(card: str, tmp: str) -> None:
    """(c) two spawned ranks on the card against one process at their
    global batch from the same init."""
    world = 2
    cfg = _dp_cfg(PRESET)
    train = spmd.compile_gpt2_train(cfg, optimizer=_dp_opt(), device=DEVICE)
    state = train.init_fn(torch.Generator().manual_seed(0))
    batch = {"tokens": _dp_tokens(cfg, DP_RANK_B * world, SEQ).to(DEVICE)}
    ref, ref_norms = [], []
    for _ in range(DP_RANK_STEPS):
        state, met = train.step_fn(state, batch)
        ref.append(float(met["loss"]))
        ref_norms.append(float(met["grad_norm"]))
    del train, state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    conf = dict(device=DEVICE, preset=PRESET, seq=SEQ, rank_b=DP_RANK_B,
                steps=DP_RANK_STEPS, chunk=DP_CHUNK)
    _join(_spawn(_dp_rank, world, (world, tmp, conf), DP_SPAWN_S))
    outs = [torch.load(os.path.join(tmp, f"dp-rank{r}.pt")) for r in
            range(world)]
    for mode, shape, int8 in DP_RANK_RUNS:
        tol = TOL_DP_INT8_LOSS if int8 else TOL_TRAIN_LOSS
        tol_n = TOL_DP_INT8_GRAD_NORM if int8 else TOL_TRAIN_GRAD_NORM
        losses, norms, same, ms = outs[0][mode]
        gap = max(abs(a - b) for a, b in zip(losses, ref))
        # int8: the steps before the first update (lr 0 at step 0)
        n_cmp = 2 if int8 else len(norms)
        gap_n = max(abs(a - b) / b for a, b in
                    zip(norms[:n_cmp], ref_norms[:n_cmp]))
        same = all(all(o[mode][2]) for o in outs)
        ok = (same and all(o[mode][0] == losses for o in outs)
              and gap <= tol and gap_n <= tol_n)
        log(f"[dp two ranks] {PRESET} T={SEQ} B={DP_RANK_B} a rank, "
            f"Topology{shape}, gloo sharing one card, {mode}"
            f"{f' chunk {DP_CHUNK}' if int8 else ''}: losses "
            f"{' '.join(f'{v:.6f}' for v in losses)}; one process at B="
            f"{DP_RANK_B * world} {' '.join(f'{v:.6f}' for v in ref)}; max "
            f"|dloss| {gap:.3g} (tol {tol}); grad norms "
            f"{' '.join(f'{v:.6f}' for v in norms)}, one process "
            f"{' '.join(f'{v:.6f}' for v in ref_norms)}, max relative gap "
            f"{gap_n:.3g} over the first {n_cmp} steps (tol {tol_n}); params bit-equal across ranks "
            f"after every step: {same}; the sync alone {ms:.1f} ms (gloo: "
            f"says nothing of NCCL) on {card}")
        if not ok:
            raise AssertionError(f"two-rank {mode} run failed its gates")


def phase_dp(card: str) -> tuple:
    """Data parallel on torch.distributed: (a) NCCL at world 1 and the
    quantizer on the card, (b) the 125M step at world 1 (returns its
    launches: the path's), (c) two gloo ranks sharing the card."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        _dp_nccl_ops(tmp)
        _dp_quantize(card)
        torch.cuda.empty_cache()
        launches = _dp_world1(card, tmp)
        torch.cuda.empty_cache()
        _dp_two_ranks(card, tmp)
        log(f"[dp] phase {time.perf_counter() - t0:.1f} s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(fn, world: int, args: tuple, timeout: float):
    """Start fn(rank, *args) in `world` spawned processes (the ranks'
    ProcessContext, not joined)."""
    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    ctx.deadline = time.monotonic() + timeout
    return ctx


def _join(ctx) -> None:
    """Wait for the ranks; raises with a failing rank's traceback, or when
    the context's deadline passes (the ranks still running are killed)."""
    try:
        while not ctx.join(timeout=5):   # raises if a rank failed
            if time.monotonic() > ctx.deadline:
                raise AssertionError("ranks did not finish by the deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _exit_codes(ctx) -> list:
    """Each process's exit code, once it ended or its context's deadline
    passed (None: killed at the deadline)."""
    codes = []
    for p in ctx.processes:
        p.join(max(0.0, ctx.deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _mesh_world1(card: str, tmp: str) -> tuple:
    """(a) GPT-2-125M through a world-1 build_mesh mesh (every axis at 1,
    params and batch as DTensors) against the one-device step from the same
    init and batch: losses and params bit-equal. The mesh run is the path
    whose launches count."""
    dev_id = {"device_id": torch.device(DEVICE, torch.cuda.current_device())
              } if DP_BACKEND == "nccl" else {}
    dist.init_process_group(DP_BACKEND, store=dist.FileStore(
        os.path.join(tmp, "mesh-world1"), 1), rank=0, world_size=1,
        **dev_id)
    try:
        mesh = build_mesh(MeshConfig(), device_type=DEVICE)
        cfg = _dp_cfg(PRESET)
        batch = {"tokens": _dp_tokens(cfg, TRAIN_B, SEQ).to(DEVICE)}
        runs, launches = _one_vs_mesh(cfg, mesh, batch, MESH_STEPS)
        (l1, s1, p1), (l2, s2, p2) = runs["one device"], runs["mesh"]
        same = l1 == l2 and all(
            torch.equal(a, b) for a, b in
            zip(spmd._leaves(p1), spmd._leaves(spmd.unshard(p2))))
        per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
        log(f"[mesh world 1] {PRESET} B={TRAIN_B} T={SEQ} remat=dots on "
            f"{DP_BACKEND}, build_mesh(MeshConfig()): axes "
            f"{mesh.mesh_dim_names} of size {mesh.size()}, {MESH_STEPS} "
            f"steps: losses {' '.join(f'{v:.6f}' for v in l2)}; one device "
            f"{' '.join(f'{v:.6f}' for v in l1)}; losses and params "
            f"{'bit-equal' if same else 'DIFFER'}; K1/K2/K3 launches "
            f"{launches} (want {per_step} a step); step "
            f"{1e3 * statistics.median(s2[2:]):.2f} ms against one device's "
            f"{1e3 * statistics.median(s1[2:]):.2f} ms (medians of steps 3+; "
            f"the difference is DTensor's dispatch) on {card}")
        if not same:
            raise AssertionError("the world-1 mesh differs from one device")
        if launches != tuple(MESH_STEPS * k for k in per_step):
            raise AssertionError(f"K1/K2/K3 launches {launches} != "
                                 f"{MESH_STEPS} x {per_step}")
        return launches
    finally:
        dist.destroy_process_group()


def _gloo_op_rank(rank: int, world: int, tmp: str, op: str) -> None:
    """One of GLOO_OPS on CUDA tensors through a gloo DeviceMesh of the
    ranks sharing card 0; writes "equal" or "WRONG"."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"gloo-{op}"), world), rank=rank, world_size=world)
    mesh = build_mesh({"tp": world}, device_type="cuda")
    w = torch.arange(32.0, device="cuda").view(4, 8)
    shard = DTensor.from_local(w.chunk(world, 1)[rank].contiguous(), mesh,
                               [Shard(1)])
    part = DTensor.from_local(w, mesh, [Partial()])
    run, want = {
        "all_gather": (lambda: shard.redistribute(mesh, [Replicate()]), w),
        "reduce_scatter": (lambda: part.redistribute(mesh, [Shard(0)]),
                           (world * w).chunk(world, 0)[rank]),
        "all_reduce": (lambda: part.redistribute(mesh, [Replicate()]),
                       world * w),
        "all_to_all": (lambda: shard.redistribute(mesh, [Shard(0)]),
                       w.chunk(world, 0)[rank]),
        "scatter": (lambda: distribute_tensor(w, mesh, [Shard(1)]),
                    w.chunk(world, 1)[rank]),
    }[op]
    got = run().to_local()
    torch.cuda.synchronize()
    with open(os.path.join(tmp, f"gloo-{op}-{rank}.txt"), "w") as f:
        f.write("equal" if got.is_cuda and torch.equal(got, want)
                else "WRONG")
    dist.barrier()
    dist.destroy_process_group()


def _gloo_cuda_ops(tmp: str) -> dict:
    """(b) each of GLOO_OPS in its own pair of ranks sharing the card, all
    pairs at once: {op: "equal" | "WRONG" | "exit codes [...]"}."""
    pairs = {op: _spawn(_gloo_op_rank, 2, (2, tmp, op), 120)
             for op in GLOO_OPS}
    out = {}
    for op, ctx in pairs.items():
        codes = _exit_codes(ctx)
        if codes != [0, 0]:
            out[op] = f"exit codes {codes}"
            continue
        words = set()
        for r in range(2):
            with open(os.path.join(tmp, f"gloo-{op}-{r}.txt")) as f:
                words.add(f.read())
        out[op] = "equal" if words == {"equal"} else "WRONG"
    return out


def _mesh_case(fam: str, conf: dict, device, impl: str = "flash"
               ) -> tuple:
    """(model module, config, tokens [B, T+1] on the CPU, the init
    generator's device) of a MESH_RUNS or SP_RUNS family, its attention
    `impl`: GPT-2 at phase 6's configuration, tinyllama at phase 8's and
    the MoE at phase 9's with conf["moe_layers"] layers, the last two with
    their weights drawn on the card."""
    if fam == "gpt2":
        cfg = dataclasses.replace(_dp_cfg(conf["preset"]), attn_impl=impl)
        return gpt2, cfg, _dp_tokens(cfg, conf["b"], conf["seq"]), "cpu"
    if fam == "llama":
        cfg = llama.LlamaConfig.preset(conf["llama_preset"], attn_impl=impl,
                                       remat=True)
        tokens = torch.randint(0, cfg.vocab_size, (conf["llama_b"],
                                                   conf["llama_t"] + 1),
                               generator=torch.Generator().manual_seed(2))
        return llama, cfg, tokens, device
    cfg = moe.MoEConfig.preset(conf["moe_preset"], n_layer=conf["moe_layers"],
                               attn_impl="flash")
    tokens = torch.randint(0, cfg.vocab_size, (conf["moe_b"],
                                               conf["moe_t"] + 1),
                           generator=torch.Generator().manual_seed(2))
    return moe, cfg, tokens, device


def _flat_params(params) -> dict:
    return {k: v.detach().float().cpu() for k, v in
            gpt2._flatten(params).items()}


def _mesh_refs(conf: dict, tmp: str) -> dict:
    """Each run of conf["runs"] in one process at the global batch:
    {label: [(loss, grad_norm)]}; GPT-2's final params go to
    ref-<label>.pt for the ranks."""
    refs = {}
    for label, fam, _, steps, *_ in conf["runs"]:
        model, cfg, tokens, init_dev = _mesh_case(fam, conf, DEVICE)
        train = spmd.compile_model_train(model, cfg, optimizer=_dp_opt(),
                                         device=DEVICE)
        state = train.init_fn(torch.Generator(device=init_dev).manual_seed(0))
        batch = {"tokens": tokens.to(DEVICE)}
        hist = []
        for _ in range(steps):
            state, met = train.step_fn(state, batch)
            hist.append((float(met["loss"]), float(met["grad_norm"])))
        refs[label] = hist
        if fam == "gpt2":
            torch.save(_flat_params(state.params),
                       os.path.join(tmp, f"ref-{label}.pt"))
        del train, state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return refs


def _mesh_rank(rank: int, world: int, tmp: str, conf: dict) -> None:
    """(c) one rank of a build_mesh mesh per run of conf["runs"]: over gloo
    every rank on card 0, over NCCL rank r on card r. Counts every launch
    from 0, one step's collectives, the step times, and for GPT-2 the
    gathered params' relative distance to the one-process run's."""
    from torch.distributed.tensor.debug import CommDebugMode

    nccl = conf["backend"] == "nccl"
    device = torch.device("cpu")
    if conf["device"] == "cuda":
        device = torch.device("cuda", rank if nccl else 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(conf["backend"], store=dist.FileStore(
        os.path.join(tmp, f"mesh-{conf['backend']}"), world), rank=rank,
        world_size=world, **({"device_id": device} if nccl else {}))
    out = {}
    for label, fam, config, steps, *impl in conf["runs"]:
        model, cfg, tokens, init_dev = _mesh_case(fam, conf, device, *impl)
        mesh = (build_hierarchical_mesh(config, Topology(*conf["topology"]),
                                        device_type=device.type)
                if conf.get("topology") else
                build_mesh(config, device_type=device.type))
        train = spmd.compile_model_train(model, cfg, mesh=mesh,
                                         optimizer=_dp_opt(), device=device)
        state = train.init_fn(torch.Generator(device=init_dev).manual_seed(0))
        batch = {"tokens": tokens.to(device)}
        _zero_counts()
        hist, secs, comm = [], [], {}
        for i in range(steps):
            t0 = time.perf_counter()
            if i == 1:
                with CommDebugMode() as mode:
                    state, met = train.step_fn(state, batch)
                comm = {str(k).rsplit(".", 1)[-1]: v
                        for k, v in mode.get_comm_counts().items()}
            else:
                state, met = train.step_fn(state, batch)
            hist.append((float(met["loss"]), float(met["grad_norm"])))
            secs.append(time.perf_counter() - t0)
        gap = None
        if fam == "gpt2":
            ref = torch.load(os.path.join(tmp, f"ref-{label}.pt"))
            got = _flat_params(spmd.unshard(state.params))
            num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref)
            den = sum(float((ref[k] ** 2).sum()) for k in ref)
            gap = math.sqrt(num / den)
        out[label] = dict(hist=hist, secs=secs, launches=_flash_counts(),
                          comm=comm, gap=gap)
        if label == conf.get("save"):
            spmd.save_state_sharded(state, os.path.join(tmp, "ckpt"),
                                    world_size=world, process_index=rank)
            saved = _state_host(state)      # a collective: every rank
            if rank == 0:
                torch.save(saved, os.path.join(tmp, "ckpt-state.pt"))
            del saved
        del train, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"mesh-rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def mesh_pair(card: str, tmp: str, backend: str) -> dict:
    """(c) MESH_RUNS on two ranks of `backend` against one process at the
    same global batch; raises if a gate fails. Returns rank 0's launches
    by path. tests/test_torch_cuda.py::test_mesh_across_cards runs it over
    NCCL on two cards."""
    return _mesh_across(card, tmp, backend, MESH_RUNS, 2)


def hier_cards(card: str, tmp: str, backend: str = "nccl") -> dict:
    """HIER_RUNS on the hierarchical mesh HIER_TOPOLOGY x tp=2, one rank a
    card over `backend` (four), against one process at the same global
    batch, under mesh_pair's gates. tests/test_torch_cuda.py::
    test_mesh_across_cards runs it on four cards."""
    return _mesh_across(card, tmp, backend, HIER_RUNS, 4, HIER_TOPOLOGY)


def _mesh_across(card: str, tmp: str, backend: str, runs, world: int,
                 topology=None) -> dict:
    """`runs` on `world` ranks of `backend` (build_mesh meshes, or with
    `topology` build_hierarchical_mesh ones) against one process."""
    conf = dict(device=DEVICE, backend=backend, preset=PRESET, seq=SEQ,
                b=MESH_B, moe_preset=MOE_PRESET, moe_layers=MESH_MOE_LAYERS,
                moe_b=MOE_B, moe_t=MOE_T, runs=runs, topology=topology)
    refs = _mesh_refs(conf, tmp)
    _join(_spawn(_mesh_rank, world, (world, tmp, conf), DP_SPAWN_S))
    outs = [torch.load(os.path.join(tmp, f"mesh-rank{r}.pt"))
            for r in range(world)]
    paths = {}
    for label, fam, config, steps in runs:
        model, cfg, _, _ = _mesh_case(fam, conf, DEVICE)
        ref, o = refs[label], outs[0][label]
        losses = [h[0] for h in o["hist"]]
        gap = max(abs(a[0] - b[0]) for a, b in zip(o["hist"], ref))
        gap_n = max(abs(a[1] - b[1]) / b[1] for a, b in zip(o["hist"], ref))
        per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
        want = tuple(steps * k for k in per_step)
        B = MESH_B if fam == "gpt2" else MOE_B
        local = (B // (config.get("dp", 1) * config.get("fsdp", 1)),
                 cfg.n_head // config.get("tp", 1))
        ok = (all(x[label]["hist"] == o["hist"] for x in outs)
              and all(x[label]["launches"] == want for x in outs)
              and all(math.isfinite(v) for h in o["hist"] for v in h)
              and gap <= TOL_TRAIN_LOSS and gap_n <= TOL_TRAIN_GRAD_NORM
              and (o["gap"] is None or o["gap"] <= TOL_TRAIN_GRAD_NORM))
        name = (PRESET if fam == "gpt2"
                else f"{MOE_PRESET} {MESH_MOE_LAYERS}-layer")
        pgap = ("not checked (MoE)" if o["gap"] is None
                else f"{o['gap']:.3g} (tol {TOL_TRAIN_GRAD_NORM})")
        log(f"[mesh {label}] {name} B={B} T="
            f"{SEQ if fam == 'gpt2' else MOE_T} on {backend}, {world} ranks, "
            f"{steps} steps: losses {' '.join(f'{v:.6f}' for v in losses)}; "
            f"one process {' '.join(f'{v:.6f}' for v, _ in ref)}; max "
            f"|dloss| {gap:.3g} (tol {TOL_TRAIN_LOSS}); grad norms "
            f"{' '.join(f'{v:.6f}' for _, v in o['hist'])}, one process "
            f"{' '.join(f'{v:.6f}' for _, v in ref)}, max relative gap "
            f"{gap_n:.3g} (tol {TOL_TRAIN_GRAD_NORM}); gathered params' "
            f"relative distance {pgap}; "
            f"K1/K2/K3 launches by rank {[x[label]['launches'] for x in outs]}"
            f" (want {want}) on local [B, H] = {list(local)}; step 2's "
            f"collectives {o['comm']}; step "
            f"{1e3 * statistics.median(o['secs'][1:]):.2f} ms (median of "
            f"steps 2+; {backend}) on {card}")
        if not ok:
            raise AssertionError(f"the {label} mesh run failed its gates")
        paths[f"{name} {label} train (a rank)"] = o["launches"]
        del model, cfg
    return paths


def phase_mesh(card: str) -> dict:
    """The named mesh on DTensor: (a) the world-1 mesh (its launches are a
    path's), (b) gloo's collectives on CUDA tensors, (c) two ranks on
    sharded meshes where gloo survives the all-gather. Returns the launches
    by path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        paths = {"gpt2-125m mesh world-1 train": _mesh_world1(card, tmp)}
        torch.cuda.empty_cache()
        ops = _gloo_cuda_ops(tmp)
        log("[mesh gloo] two ranks sharing the card, one pair an op: "
            + "; ".join(f"{op} ({GLOO_OPS[op]}): {res}"
                        for op, res in ops.items()))
        if ops["all_gather"] == "equal":
            paths.update(mesh_pair(card, tmp, "gloo"))
        else:
            log("[mesh gloo] every sharded mesh's step all-gathers (a "
                "Shard -> Replicate redistribution), which gloo did not "
                "survive on CUDA tensors here: (c) runs over NCCL on two "
                "cards in tests/test_torch_cuda.py::test_mesh_across_cards, "
                "not on this one card")
        log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _state_host(state) -> dict:
    """{leaf key: CPU tensor} of a TrainState as save_state_sharded keys
    it, DTensors gathered (a collective), the step and counts as ints."""
    from torch.distributed.tensor import DTensor

    out = {}
    for kp, leaf in ckpt_lib._flatten_with_path(spmd._state_as_tree(state)):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        out[ckpt_lib._leaf_key(kp)] = (
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else int(leaf))
    return out


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def sp_pair(card: str, tmp: str, backend: str = "nccl") -> dict:
    """SP_RUNS on two ranks over NCCL, one a card, against one process on
    one card at the same global batch (flash); then the first run's state,
    saved by both ranks, restored on one card bit-equal to the state the
    ranks held. Raises if a gate fails; returns each run's launches by
    rank. tests/test_torch_cuda.py::test_sp_across_cards runs it."""
    conf = dict(device=DEVICE, backend=backend, preset=PRESET, seq=SEQ,
                b=SP_B, llama_preset=LLAMA_TRAIN, llama_b=SP_LLAMA_B,
                llama_t=LLAMA_TRAIN_T, runs=SP_RUNS, save=SP_RUNS[0][0])
    refs = _mesh_refs(conf, tmp)
    _join(_spawn(_mesh_rank, 2, (2, tmp, conf), DP_SPAWN_S))
    outs = [torch.load(os.path.join(tmp, f"mesh-rank{r}.pt"))
            for r in range(2)]
    paths = {}
    for label, fam, config, steps, impl in SP_RUNS:
        _, cfg, _, _ = _mesh_case(fam, conf, DEVICE, impl)
        ref, o = refs[label], outs[0][label]
        gap = max(abs(a[0] - b[0]) for a, b in zip(o["hist"], ref))
        gap_n = max(abs(a[1] - b[1]) / b[1] for a, b in zip(o["hist"], ref))
        # sp rank r runs the ring's r + 1 live chunk pairs in each layer:
        # K1 in the forward and the remat recompute, K2 and K3 once
        want = [tuple(steps * k * (r + 1) if impl == "ring" else 0
                      for k in (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer))
                for r in range(2)]
        got = [x[label]["launches"] for x in outs]
        ok = (all(x[label]["hist"] == o["hist"] for x in outs)
              and got == want
              and all(math.isfinite(v) for h in o["hist"] for v in h)
              and gap <= TOL_TRAIN_LOSS and gap_n <= TOL_TRAIN_GRAD_NORM
              and (o["gap"] is None or o["gap"] <= TOL_TRAIN_GRAD_NORM))
        B, T = ((SP_B, SEQ) if fam == "gpt2"
                else (SP_LLAMA_B, LLAMA_TRAIN_T))
        pgap = ("not checked (tinyllama)" if o["gap"] is None
                else f"{o['gap']:.3g} (tol {TOL_TRAIN_GRAD_NORM})")
        log(f"[sp {label}] B={B} T={T} on {backend}, two ranks, a sequence "
            f"half "
            f"({T // 2} positions) each, {steps} steps: losses "
            f"{' '.join(f'{v:.6f}' for v, _ in o['hist'])}; one process "
            f"(flash) {' '.join(f'{v:.6f}' for v, _ in ref)}; max |dloss| "
            f"{gap:.3g} (tol {TOL_TRAIN_LOSS}); grad norms "
            f"{' '.join(f'{v:.6f}' for _, v in o['hist'])}, one process "
            f"{' '.join(f'{v:.6f}' for _, v in ref)}, max relative gap "
            f"{gap_n:.3g} (tol {TOL_TRAIN_GRAD_NORM}); gathered params' "
            f"relative distance {pgap}; K1/K2/K3 launches by rank {got} "
            f"(want {want}); step 2's collectives {o['comm']}; step "
            f"{1e3 * statistics.median(o['secs'][1:]):.2f} ms (median of "
            f"steps 2+) on {card}")
        if not ok:
            raise AssertionError(f"the {label} run failed its gates")
        paths[label] = got
    # the checkpoint of the first run, saved by the two ranks, on one card
    _, cfg, _, _ = _mesh_case(SP_RUNS[0][1], conf, DEVICE)
    train = spmd.compile_model_train(gpt2, cfg, optimizer=_dp_opt(),
                                     device=DEVICE)
    t0 = time.perf_counter()
    got = _state_host(spmd.restore_state_sharded(os.path.join(tmp, "ckpt"),
                                                 train))
    ms = 1e3 * (time.perf_counter() - t0)
    same = _same_state(got, torch.load(os.path.join(tmp,
                                                    "ckpt-state.pt")))
    log(f"[sp checkpoint] {SP_RUNS[0][0]}'s state after {SP_RUNS[0][3]} "
        f"steps, saved by both ranks, restored on one card in {ms:.1f} ms:"
        f" {'bit-equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("the sp=2 checkpoint restored on one card "
                             "differs from the ranks' state")
    return paths


def _ring_run(q, k, v, do, sp: int, scale: float) -> tuple:
    """The ring's forward and backward schedules driven for sp virtual
    ranks on q, k, v, dO [B, H, T, Dh]: ([(out, lse)], [(dq, dk, dv)]),
    one entry a rank."""
    qs, ks, vs, dos = (t.chunk(sp, dim=2) for t in (q, k, v, do))
    fwd = ring.drive_virtual([ring.ring_forward(
        qs[r], ks[r], vs[r], r, sp, True, scale) for r in range(sp)])
    bwd = ring.drive_virtual([ring.ring_backward(
        qs[r], ks[r], vs[r], *fwd[r], dos[r], r, sp, True, scale)
        for r in range(sp)])
    return fwd, bwd


def _padded_chunks(ts, sp: int) -> tuple:
    """Each tensor's sp chunks along the sequence, padded at their ends as
    the ring pads them (`ring._padded_len`), and the kv_len bound of the
    non-causal pairs (None where nothing is padded)."""
    chunks = [t.chunk(sp, dim=2) for t in ts]
    n = chunks[0][0].shape[2]
    n_pad = ring._padded_len(n)
    return ([[ring._pad_seq(c, n_pad) for c in cs] for cs in chunks],
            n if n_pad > n else None)


def _ring_pairs(q, k, v, do, fwd, sp: int, scale: float) -> tuple:
    """Each live chunk pair's K1, K2, K3 against their plain versions, K2
    and K3 fed the pair's rank's global out and lse, on the chunks as the
    ring pads them (K1 and K2 bounded by kv_len on the non-causal pairs):
    (max |d|, all within their tolerances)."""
    bf16 = torch.bfloat16
    (qs, ks, vs, dos), kv_len = _padded_chunks((q, k, v, do), sp)
    n_pad = qs[0].shape[2]
    bq = bk = fa.DEFAULT_BLOCK_Q
    worst, ok = 0.0, True
    for r in range(sp):
        out, lse = (ring._pad_seq(t, n_pad) for t in fwd[r])
        for j in range(r + 1):
            c = j == r
            kl = None if c else kv_len
            args = (qs[r], ks[j], vs[j])
            o, l = fa.flash_attention_fwd(*args, c, scale, kv_len=kl)
            po, pl = fa.flash_attention_reference(*args, c, scale,
                                                  kv_len=kl)
            dq, delta = fa.flash_attention_bwd_dq(*args, out, lse, dos[r], c,
                                                  scale, kv_len=kl)
            pdq, pdelta = fa._bwd_dq_reference(*args, out, lse, dos[r], c,
                                               scale, bq, bk, kv_len=kl)
            dk, dv = fa.flash_attention_bwd_dkv(*args, dos[r], lse, delta, c,
                                                scale)
            pdk, pdv = fa._bwd_dkv_reference(*args, dos[r], lse, pdelta, c,
                                             scale, bq, bk)
            for a, b, tol in ((o, po, TOL_PLAIN[bf16]), (l, pl, TOL_LSE),
                              (dq, pdq, TOL_GRAD_PLAIN[bf16]),
                              (delta, pdelta, TOL_LSE),
                              (dk, pdk, TOL_GRAD_PLAIN[bf16]),
                              (dv, pdv, TOL_GRAD_PLAIN[bf16])):
                err, good = close(a, b, **tol)
                worst, ok = max(worst, err), ok and good
    return worst, ok


def _ring_chunk_records(q, k, v, do, sp: int, scale: float) -> list:
    """K1, K2 and K3 on the non-causal chunk pair (rank 1's Q, rank 0's
    K/V), the ring's own shape (a ragged chunk padded, K1 and K2 bounded by
    kv_len): [{ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err}]
    for K1, K2, K3. The bounds count the real chunk's work, and SDPA runs
    on the unpadded chunk."""
    bf16 = torch.bfloat16
    (qs, ks, vs, dos), kl = _padded_chunks((q, k, v, do), sp)
    qc, kc, vc, dc = qs[1], ks[0], vs[0], dos[1]
    B, H, _, Dh = qc.shape
    n = q.shape[2] // sp
    bq = bk = fa.DEFAULT_BLOCK_Q
    o, l = fa.flash_attention_fwd(qc, kc, vc, False, scale, kv_len=kl)
    dq, delta = fa.flash_attention_bwd_dq(qc, kc, vc, o, l, dc, False, scale,
                                          kv_len=kl)
    dk, dv = fa.flash_attention_bwd_dkv(qc, kc, vc, dc, l, delta, False,
                                        scale)
    po, _ = fa.flash_attention_reference(qc, kc, vc, False, scale,
                                         kv_len=kl)
    pdq, pdelta = fa._bwd_dq_reference(qc, kc, vc, o, l, dc, False, scale,
                                       bq, bk, kv_len=kl)
    pdk, pdv = fa._bwd_dkv_reference(qc, kc, vc, dc, l, pdelta, False, scale,
                                     bq, bk)
    real = [t[:, :, :n] for t in (qc, kc, vc, dc)]
    qr, kr, vr = (t.detach().requires_grad_() for t in real[:3])
    so = F.scaled_dot_product_attention(qr, kr, vr, is_causal=False)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        *real[:3], is_causal=False))
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        so, (qr, kr, vr), real[3], retain_graph=True))
    rows = [
        (lambda: fa.flash_attention_fwd(qc, kc, vc, False, scale,
                                        kv_len=kl),
         lambda: fa.flash_attention_reference(qc, kc, vc, False, scale,
                                              kv_len=kl),
         attention_bound, close(o, po, 0, 0)[0], sdpa_fwd),
        (lambda: fa.flash_attention_bwd_dq(qc, kc, vc, o, l, dc, False,
                                           scale, kv_len=kl),
         lambda: fa._bwd_dq_reference(qc, kc, vc, o, l, dc, False, scale,
                                      bq, bk, kv_len=kl),
         dq_bound, close(dq, pdq, 0, 0)[0], sdpa_bwd),
        (lambda: fa.flash_attention_bwd_dkv(qc, kc, vc, dc, l, delta, False,
                                            scale),
         lambda: fa._bwd_dkv_reference(qc, kc, vc, dc, l, delta, False,
                                       scale, bq, bk),
         dkv_bound, max(close(dk, pdk, 0, 0)[0], close(dv, pdv, 0, 0)[0]),
         sdpa_bwd)]
    recs = []
    for run, plain, bound, err, lib in rows:
        b_ms, b_by = bound(B, H, n, n, Dh, bf16, False)
        recs.append(dict(max_abs_err=err, ms=time_ms(run),
                         plain_ms=time_ms(plain, iters=2, warmup=1),
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return recs


def phase_ring(gen: torch.Generator, card: str) -> tuple:
    """Ring attention's schedule on one card (RING_CASES): each case's
    launches count from 0 and must be sp(sp+1)/2 of each kernel (the live
    chunk pairs); the ring's out, lse, dQ, dK, dV against one K1 + K2 + K3
    over the whole sequence, and each chunk pair's kernels against their
    plain versions, within the bf16 plain tolerances; the ring timed
    against one-shot flash. A ragged case's chunks are padded as the ring
    pads them. Returns ({path: launches}, the first case's non-causal chunk
    records for K1, K2, K3, and the first ragged case's)."""
    bf16 = torch.bfloat16
    paths, chunk, ragged = {}, None, None
    for name, B, H, KV, T, Dh, sp in RING_CASES:
        layout = "qkv" if KV == H else f"gqa{H // KV}"
        q, k, v, do = _case_inputs(gen, B, H, T, Dh, bf16, layout)
        scale = 1.0 / math.sqrt(Dh)
        live = sp * (sp + 1) // 2
        _zero_counts()
        fwd, bwd = _ring_run(q, k, v, do, sp, scale)
        torch.cuda.synchronize()
        launches = _flash_counts()
        paths[f"{name} ring sp={sp} (virtual ranks)"] = launches
        out, lse = (torch.cat(t, dim=2) for t in zip(*fwd))
        grads = [torch.cat(t, dim=2) for t in zip(*bwd)]
        o1, l1 = fa.flash_attention_fwd(q, k, v, True, scale)
        g1 = fa.flash_attention_bwd(q, k, v, o1, l1, do, True, scale)
        errs = [close(a, b, **TOL_PLAIN[bf16])
                for a, b in ((out, o1), (lse, l1), *zip(grads, g1))]
        pair_err, pairs_ok = _ring_pairs(q, k, v, do, fwd, sp, scale)
        finite = all(torch.isfinite(t).all() for t in (out, lse, *grads))
        del fwd, bwd, out, lse, grads, g1
        ms = {
            "ring fwd": time_ms(lambda: ring.drive_virtual([
                ring.ring_forward(a, b, c, r, sp, True, scale)
                for r, (a, b, c) in enumerate(zip(
                    *(t.chunk(sp, dim=2) for t in (q, k, v))))]),
                iters=3, warmup=1),
            "ring fwd+bwd": time_ms(lambda: _ring_run(q, k, v, do, sp,
                                                      scale),
                                    iters=3, warmup=1),
            "one-shot fwd": time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, True, scale), iters=3, warmup=1),
            "one-shot fwd+bwd": time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, *fa.flash_attention_fwd(q, k, v, True, scale), do,
                True, scale), iters=3, warmup=1)}
        n = T // sp
        if chunk is None:
            chunk = _ring_chunk_records(q, k, v, do, sp, scale)
        elif ragged is None and ring._padded_len(n) > n:
            ragged = _ring_chunk_records(q, k, v, do, sp, scale)
            log(f"[ring chunk {name}] the ragged non-causal chunk pair B={B} "
                f"H={H} {n}x{n} (padded to {ring._padded_len(n)}, kv_len "
                f"{n}) Dh={Dh} bf16: " + "; ".join(
                    f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                    f"bound {r['bound_ms']:.4f} {r['bound_by']}, "
                    f"{100 * r['bound_ms'] / r['ms']:.2f}%, sdpa "
                    f"{r['library_ms']:.4f}, |d| vs plain "
                    f"{r['max_abs_err']:.3g})"
                    for k, r in zip(("K1", "K2", "K3"), ragged)))
        log(f"[ring {name}] B={B} H={H} ({KV} KV heads) T={T} Dh={Dh} bf16 "
            f"causal, sp={sp} virtual ranks (chunks of {T // sp}): K1/K2/K3 "
            f"launches {launches} (want {(live,) * 3}); ring vs one-shot "
            f"flash over the whole T: |d| out, lse, dQ, dK, dV "
            f"{', '.join(f'{e:.3g}' for e, _ in errs)} (tol "
            f"{TOL_PLAIN[bf16]}); each live chunk pair vs its plain "
            f"versions (K2/K3 on the global out and lse) max |d| "
            f"{pair_err:.3g}; " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in ms.items())
            + f" on {card}")
        if launches != (live,) * 3:
            raise AssertionError(f"ring {name}: launches {launches} != "
                                 f"{(live,) * 3}")
        if not (finite and pairs_ok and all(ok for _, ok in errs)):
            raise AssertionError(f"ring {name} disagrees with one-shot "
                                 f"flash or its chunk pairs with their "
                                 f"plain versions")
    name, B, H, KV, T, Dh, sp = RING_CASES[0]
    log(f"[ring chunk] {name}'s non-causal chunk pair B={B} H={H} "
        f"{T // sp}x{T // sp} Dh={Dh} bf16: " + "; ".join(
            f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.2f}%, sdpa "
            f"{r['library_ms']:.4f}, |d| vs plain {r['max_abs_err']:.3g})"
            for k, r in zip(("K1", "K2", "K3"), chunk)))
    if ragged is None:
        raise AssertionError("RING_CASES has no ragged case")
    return paths, chunk, ragged


def phase_checkpoint(card: str) -> tuple:
    """GPT-2-125M's whole TrainState at phase 6's configuration after
    CKPT_STEPS steps: save_state_sharded to a temp directory, then
    restore_state_sharded gathering and streaming; every leaf bit-equal to
    the saved state, both counts equal to the step, and one step from each
    restored state bit-equal (loss and every param) to one more step of
    the unbroken run. Launch counts start at 0: the path's steps. Returns
    them."""
    cfg = _dp_cfg(PRESET)
    batch = {"tokens": _dp_tokens(cfg, TRAIN_B, SEQ).to(DEVICE)}
    train = spmd.compile_model_train(gpt2, cfg, optimizer=_dp_opt(),
                                     device=DEVICE)
    _zero_counts()
    state = train.init_fn(torch.Generator().manual_seed(0))
    for _ in range(CKPT_STEPS):
        state, _ = train.step_fn(state, batch)
    saved = _state_host(state)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spmd.save_state_sharded(state, tmp)
        save_ms = 1e3 * (time.perf_counter() - t0)
        mb = sum(os.path.getsize(os.path.join(tmp, f))
                 for f in os.listdir(tmp)) / 1e6
        state, m = train.step_fn(state, batch)
        unbroken = (float(m["loss"]), _state_host(state))
        del state
        results = {}
        for how, kw in (("gathering", {}),
                        ("streaming", {"stream_chunk_bytes": CKPT_CHUNK})):
            t0 = time.perf_counter()
            got = spmd.restore_state_sharded(tmp, train, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            same = _same_state(_state_host(got), saved)
            counts = (got.step, got.opt_state.count)
            got, m = train.step_fn(got, batch)
            resumed = (float(m["loss"]) == unbroken[0]
                       and _same_state(_state_host(got), unbroken[1]))
            results[how] = (ms, same, counts, resumed)
            del got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _flash_counts()
    steps = CKPT_STEPS + 1 + len(results)
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
    log(f"[checkpoint {PRESET}] B={TRAIN_B} T={SEQ} remat=dots, the "
        f"TrainState after {CKPT_STEPS} steps ({len(saved)} leaves): "
        f"{mb:.2f} MB written in {save_ms:.1f} ms; " + "; ".join(
            f"{how} restore {ms:.1f} ms, leaves "
            f"{'bit-equal' if same else 'DIFFER'}, step and counts {counts}, "
            f"the next step {'bit-equal' if resumed else 'DIFFERS'} to the "
            f"unbroken run's" for how, (ms, same, counts, resumed)
            in results.items())
        + f" ({CKPT_CHUNK / 2 ** 20:g} MiB chunks streaming); K1/K2/K3 "
        f"launches {launches} over {steps} steps on {card}")
    for how, (_, same, counts, resumed) in results.items():
        if not (same and resumed and counts == (CKPT_STEPS, CKPT_STEPS)):
            raise AssertionError(f"the {how} restore is not the saved state "
                                 f"or does not resume it")
    if launches != tuple(steps * k for k in per_step):
        raise AssertionError(f"K1/K2/K3 launches {launches} != {steps} x "
                             f"{per_step}")
    return launches


def _pipe_per_step(cfg, F: int, M: int) -> tuple:
    """K1/K2/K3 launches of one pipelined step on one rank, derived from the
    schedule: at each of the M + F - 1 ticks the rank's stage runs its L/F
    blocks (bubble ticks too, as the JAX schedule does), and each block
    launches K1 in its forward and again in the remat recompute, K2 and K3
    once in its backward."""
    per_block = (2, 1, 1)
    return tuple((M + F - 1) * (cfg.n_layer // F) * k for k in per_block)


def phase_pipeline(card: str) -> tuple:
    """GPT-2-125M at phase 6's configuration through compile_pipeline_train
    on PIPE_F virtual stages of this card (the schedule the ranks run,
    driven in one process) with PIPE_M microbatches, against
    compile_model_train on one device from the same init and batch: loss
    within TOL_TRAIN_LOSS and grad norm within TOL_TRAIN_GRAD_NORM at every
    step, launches exactly F times a rank's count per step. The last step
    is profiled. Returns the launches (the path's counts)."""
    cfg = _dp_cfg(PRESET)
    B, T, F, M, steps = TRAIN_B, SEQ, PIPE_F, PIPE_M, PIPE_STEPS
    batch = {"tokens": _dp_tokens(cfg, B, T).to(DEVICE)}
    per_step = tuple(F * k for k in _pipe_per_step(cfg, F, M))
    log(f"[pipeline {PRESET}] expected K1/K2/K3 launches a step: "
        f"{per_step} = {F} stages x {M + F - 1} ticks x {cfg.n_layer // F} "
        f"blocks x (2, 1, 1)")
    ref, ref_secs, _ = _train_run(cfg, _dp_opt(), batch, steps, -1)
    torch.cuda.empty_cache()
    train = spmd.compile_pipeline_train(gpt2, cfg, MeshConfig(pp=F), M,
                                        optimizer=_dp_opt(), device=DEVICE)
    state = train.init_fn(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hier_bytes.clear()
    _zero_counts()
    hist, secs, profile = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        if i == steps - 1:
            (state, m), *profile = _profiled(
                lambda: train.step_fn(state, batch))
        else:
            state, m = train.step_fn(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))   # syncs
        secs.append(time.perf_counter() - t0)
    launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hop_bytes = sum(hier_bytes.values()) / (steps * (M + F - 1) * F)
    del train, state
    fpt = gpt2.flops_per_token(cfg, T)
    ms, tps, mfu = _train_rates(secs, steps - 1, fpt, B * T)
    ref_ms = _step_ms(ref_secs, -1)
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(hist, ref))
    d_norm = max(abs(a[1] / b[1] - 1) for a, b in zip(hist, ref))
    log(f"[pipeline {PRESET}] B={B} T={T} bf16 remat=dots, {F} virtual "
        f"stages of {cfg.n_layer // F} layers, {M} microbatches of "
        f"{B // M} ({M + F - 1} ticks, bubble {(F - 1) / (M + F - 1):.4f} "
        f"of them), {steps} steps: loss "
        f"{' '.join(f'{v:.6f}' for v, _ in hist)}, one device "
        f"{' '.join(f'{v:.6f}' for v, _ in ref)}, max |dloss| {d_loss:.3g} "
        f"(tol {TOL_TRAIN_LOSS}); grad_norm "
        f"{' '.join(f'{v:.6f}' for _, v in hist)}, one device "
        f"{' '.join(f'{v:.6f}' for _, v in ref)}, max relative gap "
        f"{d_norm:.3g} (tol {TOL_TRAIN_GRAD_NORM}); K1/K2/K3 launches "
        f"{launches} (want {tuple(steps * k for k in per_step)}); step "
        f"{ms:.2f} ms (median of steps 3+, the profiled last one left out) "
        f"against {ref_ms:.2f} ms on one device, {tps:.0f} tokens/s, MFU "
        f"{mfu:.2f}% of 989 TFLOP/s bf16; {hop_bytes / 1e6:.3f} MB a hop "
        f"(pipeline.ppermute accounted, in memory here); peak memory "
        f"{peak_gb:.2f} GB on {card}")
    _log_profile("pipeline", profile, steps - 1, secs)
    if launches != tuple(steps * k for k in per_step):
        raise AssertionError(f"pipeline launches {launches} != {steps} x "
                             f"{per_step}")
    if not all(math.isfinite(x) for h in hist for x in h):
        raise AssertionError("non-finite pipelined loss or grad norm")
    if d_loss > TOL_TRAIN_LOSS or d_norm > TOL_TRAIN_GRAD_NORM:
        raise AssertionError("the pipelined step disagrees with one device")
    return launches


def _sampled_rows(eng) -> list:
    """Every logits row `eng` samples a token from, in order, appended to
    the list returned (wraps the engine's _finish_token)."""
    rows, finish = [], eng._finish_token

    def record(i, req, row, rng):
        rows.append(row.copy())
        return finish(i, req, row, rng)
    eng._finish_token = record
    return rows


def _burst(eng, prompts: list, max_tokens: int) -> tuple:
    """The prompts at once, one thread each: (tokens, seconds, mean TTFT
    s of the burst)."""
    out = [None] * len(prompts)
    ttft0 = (eng.ttft_sum, eng.ttft_count)

    def call(j):
        out[j] = eng.generate(prompt_ids=prompts[j], max_tokens=max_tokens)

    threads = [threading.Thread(target=call, args=(j,))
               for j in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if any(o is None for o in out):
        raise AssertionError("a request got no answer")
    n = sum(len(o["token_ids"]) for o in out)
    return n, wall, ((eng.ttft_sum - ttft0[0])
                     / (eng.ttft_count - ttft0[1]))


def tp_engine_check(card: str, devices: list) -> dict:
    """The tensor-parallel engine over `devices` (two: both shards on one
    card in phase_compose, two cards in tests/test_torch_cuda.py) against
    tp=1 on the first, at phase 5's configuration: solo greedy requests
    under the TOL_TP_LOGITS gate, then a concurrent burst on each for
    tok/s and TTFT. Raises if the gate fails; returns the record."""
    import numpy as np

    kw = dict(preset=PRESET, max_batch=4, max_seq_len=SERVE_WINDOW, seed=0,
              prefill_chunk_size=64, kv_block_size=16, kv_blocks=64)
    log(f"[tp engine] stated before the run: every sampled logits row up "
        f"to the first parting within max |d| {TOL_TP_LOGITS} of tp=1's; "
        f"streams equal, or parting only where tp=1's top-2 margin is "
        f"under {TOL_TP_LOGITS} (a near-tie)")
    engines = {"tp=1": LLMEngine(device=devices[0], **kw)}
    try:
        engines["tp=2"] = LLMEngine(tensor_parallel_size=len(devices),
                                    device=devices, **kw)
        rows = {n: _sampled_rows(e) for n, e in engines.items()}
        prompts = [_prompt(seed, n) for seed, n in TP_PROMPTS]
        runs = {n: [] for n in engines}
        for prompt in prompts:
            for n, e in engines.items():
                rows[n].clear()
                toks = e.generate(prompt_ids=prompt,
                                  max_tokens=TP_NEW)["token_ids"]
                runs[n].append((toks, list(rows[n])))
        worst, first, near_ties, parted = 0.0, [], [], []
        for p, ((t1, r1), (t2, r2)) in enumerate(zip(runs["tp=1"],
                                                     runs["tp=2"])):
            j = next((i for i, (a, b) in enumerate(zip(t1, t2)) if a != b),
                     min(len(t1), len(t2)))
            # rows up to j had the same inputs on both engines
            gaps = [float(np.abs(a - b).max())
                    for a, b in zip(r1[:j + 1], r2[:j + 1])]
            worst = max(worst, *gaps)
            first += gaps[1:2]          # the first decode step's row
            if j < max(len(t1), len(t2)):
                top = np.sort(r1[j])[-2:]
                margin = float(top[1] - top[0])
                (near_ties if margin < TOL_TP_LOGITS else parted).append(
                    (p, j, round(margin, 5)))
        rates = {}
        for n, e in engines.items():
            burst = [_prompt(20 + i, 64 + 96 * i) for i in range(8)]
            tok, wall, ttft = _burst(e, burst, 64)
            rates[n] = (tok / wall, ttft * 1e3)
        rec = dict(first_decode_max=max(first, default=None), worst=worst,
                   near_ties=near_ties, parted=parted, rates=rates)
        log(f"[tp engine] {PRESET} window={SERVE_WINDOW} max_batch=4 "
            f"chunk=64, tp=2 on {[str(d) for d in devices]} against tp=1: "
            f"{len(prompts)} solo greedy requests of {TP_NEW} tokens; first "
            f"decode step's logits max |d| {rec['first_decode_max']}, every "
            f"sampled "
            f"row to the first parting {worst:.4g} (tol {TOL_TP_LOGITS}); "
            f"streams equal {len(prompts) - len(near_ties) - len(parted)}/"
            f"{len(prompts)}, near-ties (prompt, position, margin) "
            f"{near_ties}, partings past the bound {parted}; a burst of 8 "
            f"requests of 64 tokens: tp=1 {rates['tp=1'][0]:.1f} tok/s, "
            f"mean TTFT {rates['tp=1'][1]:.1f} ms; tp=2 "
            f"{rates['tp=2'][0]:.1f} tok/s, mean TTFT "
            f"{rates['tp=2'][1]:.1f} ms on {card}")
        if worst > TOL_TP_LOGITS or parted:
            raise AssertionError("the tp=2 engine disagrees with tp=1")
        return rec
    finally:
        for e in engines.values():
            e.shutdown()


def _compose_world1(card: str, tmp: str) -> tuple:
    """(b) GPT-2-125M at phase 6's configuration through
    compile_gpt2_train on the 7-D hierarchical mesh at world 1 over NCCL
    (every degree 1, Topology(1, 1): the composed path, params and rows as
    DTensors on the model sub-mesh, the sync on the local shards) against
    one device: losses and params bit-equal, exact launches."""
    dev_id = {"device_id": torch.device(DEVICE, torch.cuda.current_device())
              } if DP_BACKEND == "nccl" else {}
    dist.init_process_group(DP_BACKEND, store=dist.FileStore(
        os.path.join(tmp, "compose-world1"), 1), rank=0, world_size=1,
        **dev_id)
    try:
        mesh = full_hierarchical_mesh(topology=Topology(1, 1),
                                      device_type=DEVICE)
        cfg = _dp_cfg(PRESET)
        batch = {"tokens": _dp_tokens(cfg, TRAIN_B, SEQ).to(DEVICE)}
        runs, launches = _one_vs_mesh(cfg, mesh, batch, DP_STEPS)
        (l1, s1, p1), (l2, s2, p2) = runs["one device"], runs["mesh"]
        same = l1 == l2 and all(
            torch.equal(a, b) for a, b in
            zip(spmd._leaves(p1), spmd._leaves(spmd.unshard(p2))))
        per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
        log(f"[compose world 1] {PRESET} B={TRAIN_B} T={SEQ} remat=dots on "
            f"{DP_BACKEND}, full_hierarchical_mesh: axes "
            f"{mesh.mesh_dim_names} of size {mesh.size()}, {DP_STEPS} "
            f"steps: losses {' '.join(f'{v:.6f}' for v in l2)}; one device "
            f"{' '.join(f'{v:.6f}' for v in l1)}; losses and params "
            f"{'bit-equal' if same else 'DIFFER'}; K1/K2/K3 launches "
            f"{launches} (want {per_step} a step); step "
            f"{1e3 * statistics.median(s2[2:]):.2f} ms against one device's "
            f"{1e3 * statistics.median(s1[2:]):.2f} ms (medians of steps 3+)"
            f" on {card}")
        if not same:
            raise AssertionError("the composed world-1 step differs from "
                                 "one device")
        if launches != tuple(DP_STEPS * k for k in per_step):
            raise AssertionError(f"K1/K2/K3 launches {launches} != "
                                 f"{DP_STEPS} x {per_step}")
        return launches
    finally:
        dist.destroy_process_group()


def phase_compose(card: str) -> tuple:
    """What one card holds of the compositions: (b) the composed
    hierarchical step at world 1 (the path whose launches count, from 0),
    then (a) the tensor-parallel engine with both shards on the card (its
    cache attention is dense: no kernel). Returns (b)'s launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_compose_")
    try:
        launches = _compose_world1(card, tmp)
        torch.cuda.empty_cache()
        tp_engine_check(card, [DEVICE, DEVICE])
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pp_case(fam: str, device) -> tuple:
    """(model module, config, tokens [B, T+1] on the CPU, the init
    generator's device) of a PP_RUNS run: GPT-2 at phase 6's
    configuration, Llama-3-8B with remat and flash, TinyLlama-1.1B with
    remat and auto attention (the ring on the sp mesh, flash on one
    card), the Llamas' weights drawn on the card."""
    _, _, _, _, B, T, _ = PP_RUNS[fam]
    if fam == "gpt2":
        cfg = _dp_cfg(PRESET)
        return gpt2, cfg, _dp_tokens(cfg, B, T), "cpu"
    cfg = (llama.LlamaConfig.preset(LLAMA_TRAIN, attn_impl="auto",
                                    remat=True)
           if fam == "tinyllama-sp" else
           llama.LlamaConfig.preset(PP_LLAMA, attn_impl="flash", remat=True))
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator().manual_seed(2))
    return llama, cfg, tokens, device


def _pp_rank(rank: int, world: int, tmp: str, fam: str,
             backend: str) -> None:
    """One stage of a PP_RUNS run, over NCCL rank r on card r (over gloo on
    the CPU, a rehearsal): the init, then the steps with the launches
    counted from 0, each step timed, and the peak memory of the steps."""
    nccl = backend == "nccl"
    device = torch.device("cuda", rank) if nccl else torch.device(DEVICE)
    if nccl:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, f"pp-{backend}"), world), rank=rank,
        world_size=world, **({"device_id": device} if nccl else {}))
    _, _, config, steps, _, _, M = PP_RUNS[fam]
    model, cfg, tokens, init_dev = _pp_case(fam, device)
    mesh = build_mesh(config, device_type=device.type)
    train = spmd.compile_pipeline_train(model, cfg, mesh, M,
                                        optimizer=_dp_opt(), device=device)
    t0 = time.perf_counter()
    state = train.init_fn(torch.Generator(device=init_dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": tokens.to(device)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    hist, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, met = train.step_fn(state, batch)
        hist.append((float(met["loss"]), float(met["grad_norm"])))
        secs.append(time.perf_counter() - t0)
    torch.save(dict(hist=hist, secs=secs, launches=_flash_counts(),
                    init_s=init_s,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9),
               os.path.join(tmp, f"pp-rank{rank}.pt"))
    del train, state
    dist.barrier()
    dist.destroy_process_group()


def _pp_peak_gb(model, cfg, config: dict, B: int, T: int, M: int
                ) -> float:
    """A pipelined rank's peak memory (GB), predicted before the run: f32
    params, gradients and Adam moments (16 bytes a param) of its stage's
    layers and of the embedding and head every stage holds; the remat
    block inputs GPipe keeps for every tick ((M + F - 1) ticks x L/F
    blocks of [B/M, T/sp, d] bf16); the loss's logits over the rank's
    sequence shard ([B, T/sp, V]: bf16, its f32 copy, the f32
    log-softmax and the f32 gradient, 14 bytes a logit)."""
    F, sp = config["pp"], config.get("sp", 1)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layer
    outer = V * D * (1 if getattr(cfg, "tie_embeddings", True) else 2) + D
    local = outer + (model.num_params(cfg) - outer) // F
    acts = (M + F - 1) * (L // F) * (B // M) * (T // sp) * D * 2
    return (16 * local + acts + 14 * B * (T // sp) * V) / 1e9


def pp_cards(card: str, tmp: str, fam: str, backend: str = "nccl"
             ) -> tuple:
    """PP_RUNS[fam] over NCCL, one rank a card: GPT-2-125M on pp=2 against
    one process on one card (every step's loss within TOL_TRAIN_LOSS and
    grad norm within TOL_TRAIN_GRAD_NORM), Llama-3-8B on pp=4 against one
    card's no-grad loss_fn at the same weights and batch (the first loss
    within TOL_TRAIN_LOSS), TinyLlama-1.1B on pp=2 x sp=2 against the
    same training on one card (the first step's loss and grad norm);
    exact launches a rank (an sp rank r runs r + 1 live chunk pairs a
    block), the same losses on every rank, the peak memory a rank logged
    beside its prediction. Raises if a gate fails; returns the launches
    by rank. tests/test_torch_cuda.py::test_pp_across_cards runs it."""
    label, _, config, steps, B, T, M = PP_RUNS[fam]
    F, sp = config["pp"], config.get("sp", 1)
    model, cfg, tokens, init_dev = _pp_case(fam, DEVICE)
    predicted = _pp_peak_gb(model, cfg, config, B, T, M)
    want = [tuple(steps * k * (r % sp + 1)
                  for k in _pipe_per_step(cfg, F, M)) for r in range(F * sp)]
    log(f"[pp {label}] stated before the run: K1/K2/K3 launches by rank "
        f"{want}; peak memory a rank {predicted:.2f} GB")
    batch = {"tokens": tokens.to(DEVICE)}
    if fam == "tinyllama-sp":
        ref, ref_secs, _ = _train_run(cfg, _dp_opt(), batch, steps, -1,
                                      model=model, init_device=init_dev)
        ref = ref[:1]          # the gate: the first step's loss and norm
        ref_text = (f"one card's first step {ref[0][0]:.6f} (grad norm "
                    f"{ref[0][1]:.6f}), "
                    f"{1e3 * statistics.median(ref_secs[1:]):.2f} ms a step")
    elif fam == "gpt2":
        ref, ref_secs, _ = _train_run(cfg, _dp_opt(), batch, steps, -1)
        ref_text = (f"one process {' '.join(f'{v:.6f}' for v, _ in ref)}"
                    f" (grad norms "
                    f"{' '.join(f'{v:.6f}' for _, v in ref)}), "
                    f"{1e3 * statistics.median(ref_secs[1:]):.2f} ms a "
                    f"step")
    else:
        params = model.init_params(
            torch.Generator(device=init_dev).manual_seed(0), cfg, DEVICE)
        with torch.no_grad():
            ref = [(float(model.loss_fn(params, batch, cfg)), None)]
        del params
        ref_text = f"one card's no-grad loss_fn {ref[0][0]:.6f}"
    del batch
    torch.cuda.empty_cache()
    _join(_spawn(_pp_rank, F * sp, (F * sp, tmp, fam, backend), PP_SPAWN_S))
    outs = [torch.load(os.path.join(tmp, f"pp-rank{r}.pt"))
            for r in range(F * sp)]
    o = outs[0]
    got = [x["launches"] for x in outs]
    gap = max(abs(a[0] - b[0]) for a, b in zip(o["hist"], ref))
    gap_n = max((abs(a[1] - b[1]) / b[1] for a, b in zip(o["hist"], ref)
                 if b[1] is not None), default=0.0)
    step_ms = 1e3 * statistics.median(o["secs"][1:])
    flops = (6 * model.num_params(cfg)
             + 12 * cfg.n_layer * cfg.d_model * T) * B * T
    mfu = 100 * flops / (step_ms / 1e3) / (F * sp
                                            * PEAK_FLOPS[torch.bfloat16])
    log(f"[pp {label}] {model.num_params(cfg) / 1e9:.3f} B params, B={B} "
        f"T={T} bf16 remat, {F * sp} ranks over {backend} (one card each, "
        f"{cfg.n_layer // F} layers a stage, sp={sp}), {M} microbatches of "
        f"{B // M}, "
        f"{steps} steps: losses {' '.join(f'{v:.6f}' for v, _ in o['hist'])}"
        f" (grad norms {' '.join(f'{v:.6f}' for _, v in o['hist'])}); "
        f"{ref_text}; max |dloss| {gap:.3g} (tol {TOL_TRAIN_LOSS}), max "
        f"relative grad-norm gap {gap_n:.3g} (tol {TOL_TRAIN_GRAD_NORM}); "
        f"K1/K2/K3 launches by rank {got} (want {want}); init "
        f"{o['init_s']:.1f} s; step {step_ms:.2f} ms (median of steps 2+), "
        f"{B * T / step_ms * 1e3:.0f} tokens/s, MFU {mfu:.2f}% of {F * sp} x 989 "
        f"TFLOP/s bf16; peak memory a rank "
        f"{', '.join(f'{x['peak_gb']:.2f}' for x in outs)} GB (predicted "
        f"{predicted:.2f}) on {F * sp} x {card}")
    ok = (all(x["hist"] == o["hist"] for x in outs)
          and got == want
          and all(math.isfinite(v) for h in o["hist"] for v in h)
          and gap <= TOL_TRAIN_LOSS and gap_n <= TOL_TRAIN_GRAD_NORM)
    if not ok:
        raise AssertionError(f"the {label} run failed its gates")
    return got


def _logit_gap(a, b) -> tuple:
    """(max |a - b|, mean |a - b|) in f32."""
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def _check_gap(what, gap) -> None:
    if not (gap[0] <= TOL_LLAMA_MAX and gap[1] <= TOL_LLAMA_MEAN):
        raise AssertionError(f"{what}: max/mean |d| {gap[0]:.4g}/{gap[1]:.4g}"
                             f" past {TOL_LLAMA_MAX}/{TOL_LLAMA_MEAN}")


def phase_llama_infer(card: str) -> None:
    """llama3-8b at full width and depth: the forward through K1 (Dh=128)
    against the dense path, then KV-cache decode against the forward."""
    cfg = llama.LlamaConfig.preset(LLAMA_INFER, attn_impl="flash")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    T = LLAMA_FORWARD_T
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                           device=DEVICE)
    before = fa.flash_attention.launches
    logits = llama.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    per_forward = fa.flash_attention.launches - before
    if per_forward != cfg.n_layer:
        raise AssertionError(f"{per_forward} K1 launches in one forward, "
                             f"want {cfg.n_layer}")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    gap = _logit_gap(logits, llama.forward(params, tokens, dense_cfg))
    finite = bool(torch.isfinite(logits.float()).all())
    del logits
    ms = time_ms(lambda: llama.forward(params, tokens, cfg), iters=3,
                 warmup=1)
    dense_ms = time_ms(lambda: llama.forward(params, tokens, dense_cfg),
                       iters=3, warmup=1)
    log(f"[llama {LLAMA_INFER}] {cfg.n_layer} layers, {cfg.n_head} heads on "
        f"{cfg.n_kv_head} KV heads, Dh={cfg.head_dim}, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{llama.num_params(cfg) / 1e9:.3f} B params (f32, drawn on the card "
        f"in {init_s:.2f} s); forward B=1 T={T} bf16: {per_forward} K1 "
        f"launches; flash vs dense logits max |d| {gap[0]:.4g} mean "
        f"{gap[1]:.4g} (tol {TOL_LLAMA_MAX} / {TOL_LLAMA_MEAN}); forward "
        f"{ms:.3f} ms flash, {dense_ms:.3f} ms dense on {card}")
    if not finite:
        raise AssertionError("non-finite llama logits")
    _check_gap("llama flash vs dense forward", gap)

    # decode: the prompt token by token, then greedy tokens; the decode
    # logits at every position against one flash forward of the whole
    # sequence (K1 with T = prompt + new tokens)
    B, P, N = DECODE_B, DECODE_PROMPT, DECODE_NEW
    seq = torch.randint(0, cfg.vocab_size, (B, P + N), generator=gen,
                        device=DEVICE)
    cache = llama.init_cache(cfg, B, DECODE_CACHE, device=DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    dec, secs, profile_at = [], [], P + N // 2
    for i in range(P + N):
        def step():
            return llama.decode_step(params, cache, seq[:, i],
                                     torch.full((B,), i, device=DEVICE),
                                     active, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == profile_at:
            (out, cache), *profile = _profiled(step)
        else:
            out, cache = step()
        if P <= i + 1 < P + N:
            seq[:, i + 1] = out.argmax(-1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        dec.append(out)
    dgap = _logit_gap(torch.stack(dec, 1), llama.forward(params, seq, cfg))
    step_ms = 1e3 * statistics.median(
        s for i, s in enumerate(secs) if i >= P and i != profile_at)
    prompt_ms = 1e3 * statistics.median(secs[1:P])
    log(f"[llama {LLAMA_INFER}] decode B={B} cache {DECODE_CACHE}: "
        f"{P}-token prompt fed token by token, {N} greedy tokens; decode "
        f"vs flash forward logits over all {P + N} positions max |d| "
        f"{dgap[0]:.4g} mean {dgap[1]:.4g} (tol {TOL_LLAMA_MAX} / "
        f"{TOL_LLAMA_MEAN}); step {step_ms:.2f} ms (median of the greedy "
        f"steps, the profiled one left out; prompt steps {prompt_ms:.2f}), "
        f"{B / step_ms * 1e3:.1f} tokens/s on {card}")
    log(f"[llama {LLAMA_INFER}] decode step {profile_at + 1} under "
        f"torch.profiler: " + _profile_text(profile, step_ms))
    _check_gap("llama decode vs forward", dgap)


def _train_rates(secs, profile_at, flops_per_token, tokens) -> tuple:
    """(step ms, tokens/s, MFU %) of a run, as phase 6 computes them."""
    step_ms = _step_ms(secs, profile_at)
    return (step_ms, tokens / step_ms * 1e3, 100 * flops_per_token * tokens
            / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16])


def phase_llama_train(card: str) -> tuple:
    """tinyllama-1.1b training through compile_model_train(llama, ...) with
    remat and flash attention, then the dense path from the same params;
    launch counts start at 0 and must be exactly the per-step counts times
    the steps. Returns those counts."""
    B, T, steps = LLAMA_TRAIN_B, LLAMA_TRAIN_T, LLAMA_TRAIN_STEPS
    cfg = llama.LlamaConfig.preset(LLAMA_TRAIN, attn_impl="flash",
                                   remat=True)
    opt = spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(DEVICE)}
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    hist, secs, profile = _train_run(cfg, opt, batch, steps,
                                     LLAMA_PROFILE_STEP, llama, DEVICE)
    launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    dhist, dsecs, _ = _train_run(dense_cfg, opt, batch, LLAMA_DENSE_STEPS,
                                 None, llama, DEVICE)
    if _flash_counts() != launches:
        raise AssertionError("the dense training path launched a flash "
                             "kernel")
    # gpt2.flops_per_token's formula on this model's own parameter count
    fpt = 6 * llama.num_params(cfg) + 12 * cfg.n_layer * cfg.d_model * T
    ms, tps, mfu = _train_rates(secs, LLAMA_PROFILE_STEP, fpt, B * T)
    n = min(3, LLAMA_DENSE_STEPS)
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(hist[:n], dhist[:n]))
    d_norm = max(abs(a[1] / b[1] - 1) for a, b in zip(hist[:n], dhist[:n]))
    log(f"[train {LLAMA_TRAIN}] B={B} T={T} bf16 remat, {cfg.n_layer} "
        f"layers, {cfg.n_head} heads on {cfg.n_kv_head} KV heads, "
        f"{llama.num_params(cfg) / 1e9:.4f} B params: flash launches "
        f"K1/K2/K3 {launches} over {steps} steps (want {per_step} per step);"
        f" loss {' '.join(f'{l:.4f}' for l, _ in hist)}; grad_norm "
        f"{' '.join(f'{g:.4f}' for _, g in hist)}; dense loss "
        f"{' '.join(f'{l:.4f}' for l, _ in dhist)}, grad_norm "
        f"{' '.join(f'{g:.4f}' for _, g in dhist)}; first {n} steps flash vs "
        f"dense max |dloss| {d_loss:.3g} (tol {TOL_TRAIN_LOSS}), max "
        f"|dgrad_norm|/grad_norm {d_norm:.3g} (tol {TOL_TRAIN_GRAD_NORM}); "
        f"peak memory {peak_gb:.2f} GB (flash)")
    _log_profile("flash", profile, LLAMA_PROFILE_STEP, secs, LLAMA_TRAIN)
    log(f"[train {LLAMA_TRAIN}] flash: step {ms:.2f} ms (median of steps 3+,"
        f" the profiled one left out), {tps:.0f} tokens/s, MFU {mfu:.2f}% of "
        f"989 TFLOP/s bf16 ({fpt:.4g} FLOP/token = 6 * params + 12 * n_layer"
        f" * d_model * T) on {card}; dense: step {_step_ms(dsecs, None):.2f}"
        f" ms (median of steps 3+)")
    if launches != tuple(steps * k for k in per_step):
        raise AssertionError(f"K1/K2/K3 launches {launches} != {steps} x "
                             f"{per_step}")
    if not all(math.isfinite(x) for h in hist + dhist for x in h):
        raise AssertionError("non-finite loss or grad norm")
    if not hist[-1][0] < hist[0][0] - 0.05:
        raise AssertionError(f"loss did not fall: {hist[0][0]} -> "
                             f"{hist[-1][0]}")
    if d_loss > TOL_TRAIN_LOSS or d_norm > TOL_TRAIN_GRAD_NORM:
        raise AssertionError("flash and dense llama training disagree")
    return launches


def phase_moe(card: str) -> tuple:
    """mixtral-8x7b's widths, MOE_LAYERS layers: the forward's aux metrics,
    flash vs dense on the first step's loss, then MOE_STEPS training steps
    through compile_model_train(moe, ...). Launch counts start at 0 before
    the path; the forward must launch n_layer K1 and the steps exactly the
    per-step counts times the steps. Returns the path's counts."""
    B, T, steps = MOE_B, MOE_T, MOE_STEPS
    cfg = moe.MoEConfig.preset(MOE_PRESET, n_layer=MOE_LAYERS,
                               attn_impl="flash")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    opt = spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens.to(DEVICE)}
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
    first = {}

    def before_step(i, state):
        # step 0's params: the forward and the dense loss, under no_grad
        if i:
            return
        with torch.no_grad():
            logits, aux = moe.forward(state.params, batch["tokens"][:, :-1],
                                      cfg, return_aux=True)
            first["finite"] = bool(torch.isfinite(logits.float()).all())
            del logits
            first["aux"] = {k: float(v) for k, v in aux.items()}
            first["dense"] = float(moe.loss_fn(state.params, batch,
                                               dense_cfg))
        first["forward_launches"] = _flash_counts()

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    profile_at = steps - 1
    hist, secs, profile = _train_run(cfg, opt, batch, steps, profile_at, moe,
                                     DEVICE, before_step)
    path = _flash_counts()
    launches = tuple(a - b for a, b in zip(path, first["forward_launches"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    d_loss = abs(hist[0][0] - first["dense"])
    step_ms = _step_ms(secs, profile_at)
    full = moe.MoEConfig.preset(MOE_PRESET)
    log(f"[moe {MOE_PRESET}] {cfg.n_layer} of {full.n_layer} layers (cut: "
        f"{moe.num_params(full) / 1e9:.1f} B params with f32 Adam do not fit "
        f"one card), {cfg.n_experts} experts top-"
        f"{cfg.experts_per_token}, capacity {moe.expert_capacity(cfg, T)} "
        f"per expert and row, {cfg.n_head} heads on {cfg.n_kv_head} KV "
        f"heads, Dh={cfg.head_dim}, {moe.num_params(cfg) / 1e9:.3f} B params"
        f" ({moe.active_params(cfg) / 1e9:.3f} B active); B={B} T={T} bf16 "
        f"remat: forward K1 launches {first['forward_launches'][0]}, aux "
        + ", ".join(f"{k} {v:.5g}" for k, v in first["aux"].items())
        + f"; first-step loss flash {hist[0][0]:.4f} vs dense "
        f"{first['dense']:.4f}, |d| {d_loss:.3g} (tol {TOL_TRAIN_LOSS}); "
        f"loss {' '.join(f'{l:.4f}' for l, _ in hist)}; grad_norm "
        f"{' '.join(f'{g:.4f}' for _, g in hist)}; launches K1/K2/K3 "
        f"{launches} over {steps} steps (want {per_step} per step); step "
        f"{step_ms:.2f} ms (median of steps 3+, the profiled one left out), "
        f"{B * T / step_ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} GB"
        f" on {card}")
    _log_profile("flash", profile, profile_at, secs, MOE_PRESET)
    if first["forward_launches"] != (cfg.n_layer, 0, 0):
        raise AssertionError(f"forward launched {first['forward_launches']},"
                             f" want ({cfg.n_layer}, 0, 0)")
    if launches != tuple(steps * k for k in per_step):
        raise AssertionError(f"K1/K2/K3 launches {launches} != {steps} x "
                             f"{per_step}")
    if not (first["finite"] and all(math.isfinite(x) for h in hist
                                    for x in h)
            and all(math.isfinite(v) for v in first["aux"].values())):
        raise AssertionError("non-finite MoE logits, aux, loss or grad norm")
    if not hist[-1][0] < hist[0][0]:
        raise AssertionError(f"MoE loss did not fall: {hist[0][0]} -> "
                             f"{hist[-1][0]}")
    if d_loss > TOL_TRAIN_LOSS:
        raise AssertionError("flash and dense MoE losses disagree")
    return path


# ------------------------------------------------ phase 14: the runtime
# The core runtime drives the card: the head and its workers are the
# port's (ray_tpu_torch.core), GPUs are detected as the "GPU" resource, a
# num_gpus=1 actor serves phase 5's model and a num_gpus=1 task takes one
# step of phase 6's, each counting its own launches. The actor answers
# prompts a and b and computes a's first-token logits through
# gpt2.forward (K1 once a layer at T=256, the engine's prefill being
# dense); the task takes one step (K1 twice a layer under remat, K2 and
# K3 once).
RUNTIME_CPUS = 4
RUNTIME_OBJECT_BYTES = 256 << 20
RUNTIME_NEW = 32
RUNTIME_SPAWN_S = 600
RUNTIME_TRIPS = 20
# phase 14's driver-side server output and get time, for phase 15
RUNTIME_REF: dict = {}


def _no_tf32() -> None:
    """main()'s TF32 settings, in an actor or task's own process. The
    backends' modules are looked up by name: cloudpickle cannot ship a
    function that names `torch.backends.cuda` or `.cudnn` (module
    subclasses) by value."""
    import importlib

    importlib.import_module("torch.backends.cuda").matmul.allow_tf32 = False
    importlib.import_module("torch.backends.cudnn").allow_tf32 = False


def _rt_prompts() -> tuple:
    """phase 5's prompts a (256 tokens: forward takes K1) and b (300)."""
    shared = _prompt(1, 192)
    return _prompt(2, 256, shared), _prompt(3, 300, shared)


def _rt_serve(server, prompts) -> tuple:
    """Greedy tokens of each prompt, solo and in order, and the first
    prompt's first-token logits through gpt2.forward on the engine's
    device, brought to the CPU."""
    tokens = [server({"prompt_ids": p, "max_tokens": RUNTIME_NEW})
              ["choices"][0]["token_ids"] for p in prompts]
    eng = server.engine
    with torch.inference_mode():
        ids = torch.tensor([prompts[0]], device=eng.device)
        logits = gpt2.forward(eng.params, ids, eng.cfg)[0, -1].float().cpu()
    return tokens, logits


def _rt_server():
    return LLMServer(preset=PRESET, max_batch=4, max_seq_len=SERVE_WINDOW,
                     seed=0, prefill_chunk_size=64, kv_block_size=16,
                     kv_blocks=64, device=DEVICE)


class RuntimeServer:
    """Phase 5's server in an actor of its own (num_gpus=1)."""

    def __init__(self):
        _no_tf32()
        self.server = _rt_server()

    def serve(self, prompts) -> tuple:
        """(tokens, logits, launches counted in this process, pid)."""
        _zero_counts()
        tokens, logits = _rt_serve(self.server, prompts)
        return tokens, logits, _flash_counts(), os.getpid()


def _rt_train_step() -> dict:
    """One step of phase 6's configuration from its seeded params and batch
    (in the driver, or in a task): loss, grad norm, this process's
    launches and peak memory, and what the process has loaded."""
    _no_tf32()
    cfg = gpt2.GPT2Config.preset(PRESET, attn_impl="flash", remat=True,
                                 remat_policy="dots", ce_chunk=0)
    opt = spmd.default_optimizer(lr=6e-4, warmup=2, total_steps=1000)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, SEQ + 1),
                           generator=torch.Generator().manual_seed(1))
    train = spmd.compile_model_train(gpt2, cfg, optimizer=opt, device=DEVICE)
    state = train.init_fn(torch.Generator(device="cpu").manual_seed(0))
    on_card = torch.device(DEVICE).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    state, m = train.step_fn(state, {"tokens": tokens.to(DEVICE)})
    loss, grad_norm = float(m["loss"]), float(m["grad_norm"])   # syncs
    main = sys.modules["__main__"]
    return {"loss": loss, "grad_norm": grad_norm, "ms": 1e3 * (
                time.perf_counter() - t0),
            "launches": _flash_counts(),
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if on_card
                        else 0.0),
            "foreign": sorted(n for n in sys.modules if n.split(".")[0] in (
                "jax", "jaxlib", "ray_tpu")),
            "main": getattr(main.__spec__, "name", None), "pid": os.getpid()}


def _rt_object(nbytes: int):
    """A seeded bf16 tensor of `nbytes` on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(7)
    return torch.randn(nbytes // 2, generator=g, device=DEVICE,
                       dtype=torch.bfloat16)


def _cuda_pids() -> list:
    """The pids holding a CUDA context on the card, as nvidia-smi sees
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _driver_libs(pid: int) -> list:
    """The NVIDIA and CUDA libraries the process has mapped (the CUDA
    driver, libcuda, is mapped by any process that opens a context)."""
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    return sorted(os.path.basename(p) for p in paths
                  if "cuda" in os.path.basename(p).lower()
                  or "nvidia" in os.path.basename(p).lower())


def _wait_exit(pid: int, timeout: float = 60.0) -> float:
    """Seconds until `pid` has exited (gone, or a zombie: its CUDA context
    is released by then)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except FileNotFoundError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"process {pid} did not exit in {timeout} s")
    return time.perf_counter() - t0


class RuntimePing:
    """An actor that answers at once (its worker imports no torch)."""

    def ping(self) -> int:
        return os.getpid()


def _rt_noop() -> int:
    return 0


def _round_trips(rt, submit) -> list:
    """ms of RUNTIME_TRIPS calls, one at a time: submit, then get."""
    out = []
    for _ in range(RUNTIME_TRIPS):
        t0 = time.perf_counter()
        rt.get(submit(), timeout=RUNTIME_SPAWN_S)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _timed_puts(rt, client, values: dict) -> tuple:
    """Seconds of a put of each value, its ref, and the address of its
    bytes in the arena (None outside it)."""
    import numpy as np

    secs, refs, addrs = {}, {}, {}
    arena = client.store._get_arena()
    for k, v in values.items():
        t0 = time.perf_counter()
        refs[k] = rt.put(v)
        secs[k] = time.perf_counter() - t0
        addrs[k] = (np.frombuffer(arena.get(refs[k].id.binary(), pin=False),
                                  np.uint8).ctypes.data
                    if client.local_metas[refs[k].id].kind == "arena"
                    else None)
    return secs, refs, addrs


def _free_and_wait(rt, client, refs) -> None:
    """Free `refs` and wait until the arena no longer holds them, so the
    next puts reuse their pages."""
    rt.free(refs)
    arena = client.store._get_arena()
    deadline = time.perf_counter() + 60
    while arena is not None and any(arena.contains(r.id.binary())
                                    for r in refs):
        if time.perf_counter() > deadline:
            raise AssertionError("freed objects still in the arena")
        time.sleep(0.01)


def _first_touch(array) -> tuple:
    """Seconds of a host memcpy of `array` into a fresh buffer and into the
    same buffer again, then into a fresh shared-memory segment (the pages
    the store's arena is made of) and into it again: the cost of touching
    new pages of either kind, apart from any store."""
    from multiprocessing import shared_memory

    import numpy as np

    src = array.view(np.uint8).reshape(-1)

    def twice(dst) -> list:
        out = []
        for _ in range(2):
            t0 = time.perf_counter()
            np.copyto(dst, src)
            out.append(time.perf_counter() - t0)
        return out

    times = twice(np.empty(array.nbytes, np.uint8))
    shm = shared_memory.SharedMemory(create=True, size=array.nbytes)
    try:
        dst = np.frombuffer(shm.buf, np.uint8)
        times += twice(dst)
        del dst
    finally:
        shm.close()
        shm.unlink()
    return tuple(times)


def _runtime_launch_check(what: str, got: tuple, want: tuple) -> None:
    if tuple(got) != tuple(want):
        raise AssertionError(f"{what}: K1/K2/K3 launches {got} != {want}")


def phase_runtime(card: str) -> dict:
    """The runtime on the card: GPUs detected; the head holds no CUDA
    context; phase 5's server in a num_gpus=1 actor against the same
    server in this process; one step of phase 6's training in a
    num_gpus=1 task against the same step here; a 256 MiB bf16 CUDA tensor
    returned by a task and got back bit-equal, out of band. Returns the
    actor's and the task's launches, counted in their own processes."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.core import native_store

    cfg = gpt2.GPT2Config.preset(PRESET)
    want_actor = (cfg.n_layer, 0, 0)
    want_task = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
    prompts = _rt_prompts()
    # this process's reference step first: its state is freed before the
    # task's step, so two copies of phase 6's state never share the card
    ref_step = _rt_train_step()
    gc.collect()
    torch.cuda.empty_cache()
    t_init = time.perf_counter()
    info = rt.init(num_cpus=RUNTIME_CPUS)    # GPUs detected, not passed
    init_s = time.perf_counter() - t_init
    try:
        gpus = rt.cluster_resources().get("GPU", 0)
        head_pid = rt_api._head_proc.pid
        log(f"[runtime] session {info['session']}: init {init_s * 1e3:.0f} "
            f"ms, head pid {head_pid}, cluster {rt.cluster_resources()}; "
            f"GPUs detected {gpus:g}, torch.cuda.device_count() "
            f"{torch.cuda.device_count()}; store: "
            + ("native arena (csrc/arena_store.cc, g++)"
               if native_store.native_available()
               else "per-object shm segments (no compiler)"))
        if gpus != torch.cuda.device_count():
            raise AssertionError(f"GPUs detected {gpus} != "
                                 f"{torch.cuda.device_count()}")
        # a worker's start: the cluster has none yet, so the first actor's
        # first call waits for one to be spawned and to register
        t0 = time.perf_counter()
        pinger = rt.remote(num_cpus=0)(RuntimePing).remote()
        ping_pid = rt.get(pinger.ping.remote(), timeout=RUNTIME_SPAWN_S)
        log(f"[runtime] worker start (the first actor's first call: its "
            f"worker, pid {ping_pid}, spawned, the port's core imported, no "
            f"torch) {1e3 * (time.perf_counter() - t0):.1f} ms")

        # serving: the actor's server against this process's
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(RuntimeServer).remote()
        a_tokens, a_logits, a_launches, a_pid = rt.get(
            actor.serve.remote(prompts), timeout=RUNTIME_SPAWN_S)
        serve_s = time.perf_counter() - t0
        pids = _cuda_pids()
        log(f"[runtime] actor pid {a_pid} (num_gpus=1): {PRESET} server "
            f"built and prompts a, b answered in {serve_s:.2f} s (worker "
            f"start, torch import and build included); nvidia-smi compute "
            f"pids {pids} (the head's {head_pid}); driver libraries mapped "
            f"by the head {_driver_libs(head_pid)}, by the actor "
            f"{_driver_libs(a_pid)}")
        if head_pid in pids or any(lib.startswith("libcuda.")
                                   for lib in _driver_libs(head_pid)):
            raise AssertionError("the head holds a CUDA context")
        rt.kill(actor)
        exit_s = _wait_exit(a_pid)
        server = _rt_server()
        try:
            d_tokens, d_logits = _rt_serve(server, prompts)
        finally:
            server.shutdown()
        # phase 15 holds its actor against this process's server too
        RUNTIME_REF.update(tokens=d_tokens, logits=d_logits)
        gap = float((a_logits - d_logits).abs().max())
        same = a_tokens == d_tokens
        log(f"[runtime] actor vs this process: greedy tokens of a and b "
            f"equal: {same}; first-token logits max |d| {gap:.4g} (tol "
            f"{TOL_LOGITS}), bit-equal {torch.equal(a_logits, d_logits)}; "
            f"actor launches K1/K2/K3 {a_launches} (want {want_actor}); "
            f"actor killed, its process gone in {exit_s:.2f} s")
        if not same:
            raise AssertionError("the actor's greedy tokens differ")
        if gap > TOL_LOGITS:
            raise AssertionError("the actor's first-token logits differ")
        _runtime_launch_check("actor", a_launches, want_actor)

        # training: one step in a task against this process's
        t0 = time.perf_counter()
        step = rt.get(rt.remote(num_gpus=1, max_retries=0)(
            _rt_train_step).remote(), timeout=RUNTIME_SPAWN_S)
        task_s = time.perf_counter() - t0
        d_loss = abs(step["loss"] - ref_step["loss"])
        d_norm = abs(step["grad_norm"] / ref_step["grad_norm"] - 1)
        log(f"[runtime] task pid {step['pid']} (num_gpus=1, __main__ "
            f"{step['main']}, foreign modules {step['foreign']}): one "
            f"{PRESET} step B={TRAIN_B} T={SEQ} remat=dots loss "
            f"{step['loss']:.6f} grad_norm {step['grad_norm']:.6f} vs this "
            f"process {ref_step['loss']:.6f} {ref_step['grad_norm']:.6f}: "
            f"|dloss| {d_loss:.3g} (tol {TOL_TRAIN_LOSS}), |dgrad_norm|/"
            f"grad_norm {d_norm:.3g} (tol {TOL_TRAIN_GRAD_NORM}), bit-equal "
            f"{step['loss'] == ref_step['loss'] and step['grad_norm'] == ref_step['grad_norm']}; "
            f"step {step['ms']:.1f} ms in the task (its first, compile-free "
            f"but cold) vs {ref_step['ms']:.1f} ms here; peak memory "
            f"{step['peak_gb']:.2f} GB task, {ref_step['peak_gb']:.2f} GB "
            f"here; task round trip {task_s:.2f} s; launches K1/K2/K3 "
            f"{step['launches']} (want {want_task})")
        if step["foreign"] or step["main"] != "ray_tpu_torch.core.worker_main":
            raise AssertionError("the task's worker is not the port's")
        if d_loss > TOL_TRAIN_LOSS or d_norm > TOL_TRAIN_GRAD_NORM:
            raise AssertionError("the task's step disagrees with this "
                                 "process's")
        _runtime_launch_check("task", step["launches"], want_task)

        # objects: a 256 MiB bf16 CUDA tensor through the store
        client = rt_api._global_client()
        nbytes = RUNTIME_OBJECT_BYTES
        ref = rt.remote(num_gpus=1)(_rt_object).remote(nbytes)
        rt.wait([ref], timeout=RUNTIME_SPAWN_S)
        t0 = time.perf_counter()
        got = rt.get(ref)
        get_ms = 1e3 * (time.perf_counter() - t0)
        want = _rt_object(nbytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = want.cpu()
        d2h_s = time.perf_counter() - t0
        # puts of the same bytes as a CPU tensor, a numpy array and the
        # tensor on the card: first into arena pages this process has
        # never touched, then, after those are freed, again
        values = {"tensor": host, "numpy": host.view(torch.int16).numpy(),
                  "card": want}
        cold, refs, cold_at = _timed_puts(rt, client, values)
        kinds = {k: client.local_metas[r.id].kind for k, r in refs.items()}
        t0 = time.perf_counter()
        back = rt.get(refs["card"]).to(DEVICE)
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t0
        _free_and_wait(rt, client, list(refs.values()))
        warm, refs, warm_at = _timed_puts(rt, client, values)
        _free_and_wait(rt, client, list(refs.values()))
        reused = sorted(k for k in values if warm_at[k] is not None
                        and warm_at[k] in cold_at.values())
        touch = _first_touch(values["numpy"])
        meta = client.local_metas[ref.id]
        ser = client.read_serialized(meta)
        RUNTIME_REF["same_node_get_ms"] = get_ms
        bit_equal = (got.dtype == torch.bfloat16 and got.device.type == "cpu"
                     and torch.equal(got.view(torch.int16),
                                     want.cpu().view(torch.int16))
                     and torch.equal(back.view(torch.int16),
                                     want.view(torch.int16)))
        gbps = lambda s: nbytes / s / 1e9   # noqa: E731
        log(f"[runtime] object: a task's {nbytes >> 20} MiB bf16 CUDA "
            f"tensor came back as a {got.device.type} {got.dtype} tensor "
            f"{tuple(got.shape)}, bit-equal {bit_equal}; store kind "
            f"{meta.kind}, pickle meta {len(ser.meta)} B, {len(ser.buffers)} "
            f"out-of-band buffer(s) of {[b.nbytes for b in ser.buffers]} B; "
            f"get (shm -> CPU tensor viewing shm, no copy) {get_ms:.3f} ms; "
            f".cpu() {gbps(d2h_s):.2f} GB/s; put GB/s into untouched arena "
            f"pages / into pages freed and reused: "
            + "; ".join(f"{k} {gbps(cold[k]):.2f} / {gbps(warm[k]):.2f}"
                        for k in values)
            + f" (kinds {kinds}; the second puts at the first puts' "
            f"addresses: {reused}); get and back onto the card "
            f"{gbps(back_s):.2f} GB/s; host memcpy of the bytes into a fresh "
            f"buffer {gbps(touch[0]):.2f} GB/s, into the same buffer again "
            f"{gbps(touch[1]):.2f} GB/s, into a fresh shm segment "
            f"{gbps(touch[2]):.2f} GB/s, into the same segment again "
            f"{gbps(touch[3]):.2f} GB/s; on {card}")
        if not bit_equal:
            raise AssertionError("the tensor did not come back bit-equal")
        if len(ser.meta) >= 1024 or [b.nbytes for b in ser.buffers] != [
                nbytes]:
            raise AssertionError("the tensor's bytes did not go out of band")
        del got, want, back, host, values

        # round trips on warm workers: the first actor's calls, and no-op
        # tasks
        actor_ms = _round_trips(rt, lambda: pinger.ping.remote())
        rt.kill(pinger)
        noop = rt.remote(_rt_noop)
        task_ms = _round_trips(rt, lambda: noop.remote())
        log(f"[runtime] round trip median of {RUNTIME_TRIPS} "
            f"(min, max): actor call {statistics.median(actor_ms):.3f} ms "
            f"({min(actor_ms):.3f}, {max(actor_ms):.3f}), no-op task "
            f"{statistics.median(task_ms):.3f} ms ({min(task_ms):.3f}, "
            f"{max(task_ms):.3f}; its first, {task_ms[0]:.3f} ms, "
            f"included)")
    finally:
        _shutdown_runtime(rt, rt_api)
    return {"runtime actor serve": tuple(a_launches),
            "runtime task train": tuple(step["launches"])}


def _shutdown_runtime(rt, rt_api) -> None:
    """rt.shutdown(), then check that every worker the head started is
    gone (the head kills them as it stops)."""
    pids = [w["pid"] for w in rt_api._global_client().head_request(
        "list_state", kind="workers") if not w["is_driver"]]
    rt.shutdown()
    for pid in pids:
        _wait_exit(pid, timeout=30.0)


# -------------------------------------- phase 15: the runtime across nodes
# Two node daemons on the one card stand for two GPU nodes (num_gpus=1
# each, the reference's way of faking accelerators per node), under a
# head with no GPU and with store isolation (each node its own store
# namespace, so objects really cross nodes through the data plane). Phase
# 5's server runs in a detached num_gpus=1 actor, outlives a head restart
# and moves to the other node when its node is killed; a remote driver
# reaches it through the head's client proxy. The actor counts its own
# launches: prompt a's first-token logits through gpt2.forward take K1
# once a layer.
MULTI_ACTOR = "phase15-server"
MULTI_HEAD_WAIT_S = 60
MULTI_PROBE_S = 5.0
MULTI_READOPT_S = 30   # the wait for the actor's process to re-register


class MultiNodeServer(RuntimeServer):
    """Phase 5's server in a detached actor; it also says where it runs
    and answers with tokens alone (a remote driver needs no torch)."""

    def node(self) -> tuple:
        import ray_tpu_torch

        return os.getpid(), ray_tpu_torch.get_runtime_context().node_id.hex()

    def tokens(self, prompts) -> tuple:
        return ([self.server({"prompt_ids": p, "max_tokens": RUNTIME_NEW})
                 ["choices"][0]["token_ids"] for p in prompts], os.getpid())


def _rt_where() -> str:
    import ray_tpu_torch

    return ray_tpu_torch.get_runtime_context().node_id.hex()


_REMOTE_DRIVER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[3])
import ray_tpu_torch as rt

rt.init(address=sys.argv[1])
h = rt.get_actor(sys.argv[2])
tokens, pid = rt.get(h.tokens.remote([json.loads(sys.argv[4])]), timeout=600)
with open("/proc/self/maps") as f:
    libs = sorted({os.path.basename(l.split()[-1]) for l in f if "/" in l
                   and ("cuda" in l.lower() or "nvidia" in l.lower())})
print(json.dumps({"tokens": tokens[0], "pid": pid, "libs": libs,
                  "torch": "torch" in sys.modules}))
rt.shutdown()
"""


def _check_no_context(pids: dict) -> None:
    """None of these control-plane processes maps the CUDA driver."""
    for what, pid in pids.items():
        libs = _driver_libs(pid)
        if any(lib.startswith("libcuda.") for lib in libs):
            raise AssertionError(f"the {what} (pid {pid}) maps {libs}")


def _restart_events(state, t_kill: float, client) -> str:
    """The restarted head's scheduling events and its actor records since
    the kill, each at its seconds after the kill, to say why a surviving
    actor process was not re-adopted."""
    try:
        events = [f"{e['ts'] - t_kill:.2f} s {e['kind']} "
                  + " ".join(f"{k}={v}" for k, v in e.items()
                             if k not in ("ts", "kind"))
                  for e in state.list_lease_events()
                  if e.get("ts", 0) >= t_kill][:60]
        actors = [{k: a.get(k) for k in ("name", "state", "node_id",
                                         "restarts_left")}
                  for a in client.head_request("list_state", kind="actors")]
        workers = [(w["pid"], w["node_id"][:8], w["actor"] and w["actor"][:8])
                   for w in client.head_request("list_state", kind="workers")
                   if not w["is_driver"]]
    except Exception as e:   # the diagnosis must not hide the failure
        return f"events unreadable: {e!r}"
    return (f"events since the kill: {events}; actors: {actors}; workers "
            f"(pid, node, actor): {workers}")


def _head_row(state) -> dict:
    return next(r for r in state.list_scheduler_stats() if r.get("is_head"))


def phase_multinode(card: str) -> dict:
    """The runtime across nodes on the card (phase 15): bring-up, serving
    on a daemon, a tensor across nodes, a head restart, a node death and a
    remote driver. Returns the actor's launches, counted in its own
    process, before and after its node's death."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.util import state
    import ray_tpu_torch as rt

    cfg = gpt2.GPT2Config.preset(PRESET)
    want = (cfg.n_layer, 0, 0)
    prompts = _rt_prompts()
    ref_tokens, ref_logits = RUNTIME_REF["tokens"], RUNTIME_REF["logits"]
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = None
    try:
        # 1. bring-up: a head with no GPU, two one-GPU daemons
        t0 = time.perf_counter()
        c = Cluster(num_cpus=0, enable_snapshots=True)
        nodes = {c.add_node(num_cpus=2, num_gpus=1, labels={"zone": z}): z
                 for z in ("a", "b")}
        c.connect()
        c.wait_for_nodes(3)
        res = rt.cluster_resources()
        log(f"[multinode] head + daemons {sorted(v for v in nodes.values())}"
            f" up in {time.perf_counter() - t0:.2f} s; cluster {res}; "
            f"store isolation on")
        if res.get("GPU") != 2:
            raise AssertionError(f"cluster GPUs {res.get('GPU')} != 2")
        control = {"head": c._head.pid,
                   **{f"daemon {z}": p.pid for z, p in
                      zip(("a", "b"), c._nodes)}}

        # 2. serving on a daemon: the actor's node is N1, the other N2
        t0 = time.perf_counter()
        actor = rt.remote(MultiNodeServer).options(
            num_gpus=1, max_restarts=1, lifetime="detached",
            name=MULTI_ACTOR).remote()
        tokens, logits, launches, a_pid = rt.get(
            actor.serve.remote(prompts), timeout=RUNTIME_SPAWN_S)
        serve_s = time.perf_counter() - t0
        _, n1 = rt.get(actor.node.remote(), timeout=60)
        n2 = next(n for n in nodes if n != n1)
        gap = float((logits - ref_logits).abs().max())
        log(f"[multinode] actor pid {a_pid} on node {nodes.get(n1, n1)} "
            f"(a daemon's: {n1 in nodes}): server built and prompts a, b "
            f"answered in {serve_s:.2f} s; greedy tokens equal to phase "
            f"14's driver-side server: {tokens == ref_tokens}; first-token "
            f"logits max |d| {gap:.4g} (tol {TOL_LOGITS}); launches "
            f"K1/K2/K3 {launches} (want {want})")
        if n1 not in nodes:
            raise AssertionError("the actor is not on a daemon's node")
        if tokens != ref_tokens or gap > TOL_LOGITS:
            raise AssertionError("the actor's output differs from the "
                                 "driver's server")
        _runtime_launch_check("multinode actor", launches, want)
        _check_no_context(control)
        paths = {"multinode actor serve": tuple(launches)}

        # 3. a tensor across nodes: made on N2, got in the head's
        # namespace through the chunked data plane
        nbytes = RUNTIME_OBJECT_BYTES
        ref = rt.remote(_rt_object).options(
            num_gpus=1, label_selector={"zone": nodes[n2]}).remote(nbytes)
        rt.wait([ref], timeout=RUNTIME_SPAWN_S)
        client = rt_api._global_client()
        t0 = time.perf_counter()
        got = rt.get(ref, timeout=600)
        pull_s = time.perf_counter() - t0
        local = client._pulled.get(ref.id) or client._daemon_pulled.get(
            ref.id)
        ser = client.store.get_serialized(local) if local else None
        want_t = _rt_object(nbytes).cpu()
        bit_equal = (got.dtype == torch.bfloat16 and got.device.type == "cpu"
                     and torch.equal(got.view(torch.int16),
                                     want_t.view(torch.int16)))
        same_ms = RUNTIME_REF.get("same_node_get_ms")
        RUNTIME_REF["pull_gbps"] = nbytes / pull_s / 1e9   # for phase 16
        log(f"[multinode] a task's {nbytes >> 20} MiB bf16 CUDA tensor on "
            f"node {nodes[n2]} got in the head's namespace as a "
            f"{got.device.type} {got.dtype} tensor, bit-equal {bit_equal}; "
            f"pulled across nodes: {local is not None}; pickle meta "
            f"{len(ser.meta) if ser else None} B, out-of-band buffers "
            f"{[b.nbytes for b in ser.buffers] if ser else None}; cross-node "
            f"get {1e3 * pull_s:.1f} ms = {nbytes / pull_s / 1e9:.3f} GB/s; "
            f"same-node get of the same bytes (phase 14, a view of shm, no "
            f"copy) {same_ms:.3f} ms")
        if not bit_equal or local is None:
            raise AssertionError("the tensor did not cross nodes bit-equal")
        if len(ser.meta) >= 1024 or [b.nbytes for b in ser.buffers] != [
                nbytes]:
            raise AssertionError("the tensor's bytes did not go out of band")
        del got, want_t, ser
        rt.free([ref])

        # 4. head restart while the actor lives
        epoch0 = _head_row(state)["epoch"]
        time.sleep(2.5)   # a snapshot cycle (every 2 s)
        t_kill = time.time()
        t0 = time.perf_counter()
        c.kill_head()
        c.restart_head(restore=True)
        up_s = time.perf_counter() - t0
        # a second num_gpus=1 task pinned to N1 the moment the head is
        # back, racing the actor's re-adoption: it must not run
        probe = rt.remote(_rt_where).options(
            num_gpus=1, label_selector={"zone": nodes[n1]}).remote()
        again, pid_r = rt.get(actor.tokens.remote(prompts[:1]),
                              timeout=RUNTIME_SPAWN_S)
        answer_s = time.perf_counter() - t0
        lows = []   # every node's free CPU and GPU, sampled until reconciled

        def reconciled():
            try:
                lows.extend(min(n["available"].get(r, 0)
                                for r in ("CPU", "GPU"))
                            for n in state.list_nodes())
                rows = [r for r in state.list_scheduler_stats()
                        if not r.get("is_head")]
            except Exception:
                return False  # this driver's own reconnect is under way
            return len(rows) == 2 and all(r["reconciled"] for r in rows)

        deadline = time.perf_counter() + MULTI_HEAD_WAIT_S
        while not reconciled():
            if time.perf_counter() > deadline:
                raise AssertionError("the daemons never reconciled")
            time.sleep(0.1)
        back_s = time.perf_counter() - t0
        epoch1 = _head_row(state)["epoch"]
        # the actor's process re-registers on its own reconnect backoff,
        # which may retry after its daemon has reconciled: wait for the
        # head's record of who hosts the actor
        aid = actor._actor_id.hex()
        deadline = time.perf_counter() + MULTI_READOPT_S
        while True:
            hosts = sorted(
                w["pid"] for w in rt_api._global_client().head_request(
                    "list_state", kind="workers") if w.get("actor") == aid)
            if hosts or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        readopt_s = time.perf_counter() - t0
        avail = {n["node_id"]: n["available"].get("GPU", 0)
                 for n in state.list_nodes()}
        total = rt.cluster_resources().get("GPU")
        ready, _ = rt.wait([probe], timeout=MULTI_PROBE_S)
        rt.cancel(probe, force=True)
        kept = pid_r == a_pid and hosts == [a_pid]
        log(f"[multinode] head killed and restarted with --restore: serving "
            f"again in {up_s:.2f} s, the actor's first answer after "
            f"{answer_s:.2f} s, both daemons reconciled after {back_s:.2f} "
            f"s, the head's record of the actor's process after "
            f"{readopt_s:.2f} s; epoch {epoch0} -> {epoch1}; the actor kept its process "
            f"(pid {pid_r}, the head's record {hosts}): {kept}, "
            f"re-created: {not kept}; prompt a's tokens equal: "
            f"{again[0] == ref_tokens[0]}; GPU total {total}, available on "
            f"N1 {avail.get(n1)}, on N2 {avail.get(n2)}, the least free "
            f"CPU or GPU on a node while reconciling {min(lows)}; a "
            f"num_gpus=1 task pinned to N1 from the head's return on ran "
            f"by {MULTI_PROBE_S:g} s after the reconcile: {bool(ready)}")
        if again[0] != ref_tokens[0]:
            raise AssertionError("the actor's tokens changed across the "
                                 "head restart")
        if not kept:
            raise AssertionError(
                f"the restarted head did not re-adopt the actor's surviving "
                f"process (pid {a_pid}; answered from {pid_r}; the head's "
                f"record {hosts}); "
                f"{_restart_events(state, t_kill, rt_api._global_client())}")
        if epoch1 <= epoch0:
            raise AssertionError("the head's epoch was not bumped")
        if total != 2 or avail.get(n1) != 0 or min(lows) < 0:
            raise AssertionError("the GPU ledger is wrong after the restart")
        if ready:
            raise AssertionError("N1's GPU was granted twice")
        control["head"] = c._head.pid
        _check_no_context(control)

        # 5. node death: N1's daemon and its processes killed
        t0 = time.perf_counter()
        c.kill_node(n1)
        deadline = t0 + RUNTIME_SPAWN_S
        while True:
            try:
                tokens2, _, launches2, pid2 = rt.get(
                    actor.serve.remote(prompts), timeout=RUNTIME_SPAWN_S)
                break
            except Exception as e:   # the restart is under way
                if time.perf_counter() > deadline:
                    raise
                log(f"[multinode] waiting for the restarted actor: "
                    f"{type(e).__name__}")
                time.sleep(0.5)
        moved_s = time.perf_counter() - t0
        _, n_after = rt.get(actor.node.remote(), timeout=60)
        log(f"[multinode] N1 killed: the actor restarted on node "
            f"{nodes.get(n_after, n_after)} (N2: {n_after == n2}, pid "
            f"{pid2}); from the kill to its first answer {moved_s:.2f} s; "
            f"tokens of a and b equal: {tokens2 == ref_tokens}; launches "
            f"{launches2} (want {want})")
        if n_after != n2 or tokens2 != ref_tokens:
            raise AssertionError("the actor did not move to N2 intact")
        _runtime_launch_check("restarted actor", launches2, want)
        paths["multinode restarted actor serve"] = tuple(launches2)

        # 6. a remote driver through the client proxy, with no card
        port = rt_api._global_client().head_request(
            "cluster_info")["client_proxy_port"]
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", _REMOTE_DRIVER,
             f"ray-tpu://127.0.0.1:{port}", MULTI_ACTOR,
             os.path.dirname(os.path.abspath(__file__)),
             json.dumps(prompts[0])],
            capture_output=True, text=True, timeout=600, env=env)
        remote_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the remote driver failed: "
                                 f"{out.stderr[-2000:]}")
        rem = json.loads(out.stdout.strip().splitlines()[-1])
        log(f"[multinode] remote driver over ray-tpu://127.0.0.1:{port} "
            f"(CUDA_VISIBLE_DEVICES=''): prompt a's tokens equal "
            f"{rem['tokens'] == ref_tokens[0]}, from actor pid {rem['pid']}; "
            f"torch imported {rem['torch']}; driver libraries mapped "
            f"{rem['libs']}; {remote_s:.2f} s")
        if rem["tokens"] != ref_tokens[0]:
            raise AssertionError("the remote driver's tokens differ")
        if any(lib.startswith("libcuda.") for lib in rem["libs"]):
            raise AssertionError("the remote driver holds a CUDA context")
        rt.kill(actor)
        return paths
    finally:
        # 7. teardown: nothing of the session stays
        try:
            rt.shutdown()
        finally:
            os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
            if c is not None:
                c.shutdown()
                left, segs = c.processes(), c.segments()
                log(f"[multinode] shutdown: processes left {left}, "
                    f"segments left {segs}")
                if left or segs:
                    raise AssertionError("the cluster leaked")


# ----------------------- phase 16: the object plane's device half, served
# Phase 15's cluster shape again (two one-GPU daemons on the one card, a
# head with no GPU, store isolation). (a) a num_gpus=1 actor on node a
# keeps prompt a's first-token logits (gpt2.forward: K1 once a layer,
# counted in its process) and phase 14's 256 MiB bf16 tensor on its card
# as a device object, got by itself (the living tensors), by this process
# and by an actor on node a (one snapshot staged between them) and by an
# actor on node b (the chunked pull); (b) phase 14's server built from the
# seeded GPT-2-125M checkpoint: R1 on node a reads the checkpoint and
# publishes it on the weight plane, R2 on node b pulls it from R1 with no
# head RPC; (c) R2 warm-starts from the cluster prefix tier a prompt R1
# served.
OBJ_SHARED_LEN = 600     # (c)'s shared prompt, past 512 tokens
OBJ_WAIT_S = 60


def _digest(t) -> str:
    """blake2b of a tensor's bytes, brought to the host."""
    import hashlib

    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.blake2b(raw.numpy(), digest_size=16).hexdigest()


def _device_stats() -> dict:
    """This process's device-object counts: snapshots staged and their
    device-to-host copies, host-to-device copies on get, values held."""
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.core import device_transport as dt

    client = rt_api._global_client()
    return {**{k: dt.STATS[k] for k in ("snapshots_staged", "d2h_copies",
                                        "h2d_copies")},
            "device_objects": len(client.device_store),
            "cached_snapshots": len(client._device_snapshots)}


def _want_device() -> str:
    """Where a consumer's rematerialized CUDA leaves must land."""
    return "cuda:0" if torch.device(DEVICE).type == "cuda" else "cpu"


def _obj_fetch(ref) -> dict:
    """A device object's get, timed: where each leaf landed, its digest,
    and whether the snapshot was pulled across nodes."""
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.core.device_transport import snapshot_oid
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    val = rt.get(ref, timeout=600)
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    client = rt_api._global_client()
    snap = snapshot_oid(ref.id)
    return {"ms": ms, "devices": {k: str(v.device) for k, v in val.items()},
            "digests": {k: _digest(v) for k, v in val.items()},
            "pulled": snap in client._pulled or snap in client._daemon_pulled,
            "pid": os.getpid()}


class ObjectsOwner:
    """(a)'s owner: the seeded GPT-2-125M params on its card."""

    def __init__(self):
        _no_tf32()
        self.cfg = _rt_cfg()
        self.params = gpt2.init_params(torch.Generator().manual_seed(0),
                                       self.cfg, DEVICE)
        self.out = self.launches = None

    @ray_tpu_torch.method(tensor_transport="device")
    def produce(self, prompt) -> dict:
        _zero_counts()
        with torch.inference_mode():
            ids = torch.tensor([prompt], device=DEVICE)
            logits = gpt2.forward(self.params, ids, self.cfg)[0, -1]
        self.launches = _flash_counts()
        self.out = {"logits": logits.clone(),
                    "blob": _rt_object(RUNTIME_OBJECT_BYTES)}
        return self.out

    def same(self, box) -> dict:
        """The owner's own get: the living tensors, the same data_ptr."""
        import ray_tpu_torch as rt

        got = rt.get(box["r"], timeout=60)
        return {k: got[k] is v and got[k].data_ptr() == v.data_ptr()
                for k, v in self.out.items()}

    def digests(self) -> dict:
        return {k: _digest(v) for k, v in self.out.items()}

    def snapshot(self, box) -> dict:
        """The cached snapshot: its store kind, meta bytes, out-of-band
        buffer bytes, and whether the store still holds it."""
        from ray_tpu_torch.core import api as rt_api
        from ray_tpu_torch.core.device_transport import snapshot_oid

        client = rt_api._global_client()
        meta = client._device_snapshots.get(box["r"].id)
        if meta is None:
            return {"held": False}
        ser = client.store.get_serialized(meta)
        return {"held": True, "kind": meta.kind, "meta": len(ser.meta),
                "buffers": [b.nbytes for b in ser.buffers],
                "oid": snapshot_oid(box["r"].id).binary()}

    def arena(self, oid: bytes = b"") -> tuple:
        """(bytes used in this node's arena, whether it holds `oid`)."""
        from ray_tpu_torch.core import api as rt_api

        arena = rt_api._global_client().store._get_arena()
        if arena is None:
            return None, False
        return arena.stats()[0], bool(oid) and arena.contains(oid)

    def stats(self) -> dict:
        return {**_device_stats(), "launches": self.launches,
                "leaf_bytes": sorted(v.numel() * v.element_size()
                                     for v in (self.out or {}).values())}

    def drop(self) -> bool:
        self.out = None
        return True


class ObjectsConsumer:
    """A get of (a)'s device object in a process of its own."""

    def warm(self) -> int:
        """This process's CUDA context, made before the timed get."""
        if torch.device(DEVICE).type == "cuda":
            torch.zeros(1, device=DEVICE)
            torch.cuda.synchronize()
        return os.getpid()

    def fetch(self, box) -> dict:
        return _obj_fetch(box["r"])


class PlaneReplica:
    """(b) and (c)'s replica: phase 14's server built from the checkpoint,
    with the cluster prefix tier."""

    def __init__(self):
        _no_tf32()
        self.server = None

    def wait_binding(self, ckpt: str) -> float:
        """Seconds until this process's directory resolves `ckpt` on the
        weight plane."""
        from ray_tpu_torch.serve import weight_store as ws

        t0 = time.perf_counter()
        while ws.get_store().resolve(ckpt) is None:
            if time.perf_counter() - t0 > OBJ_WAIT_S:
                raise AssertionError(f"{ckpt} never reached the directory")
            time.sleep(0.05)
        return time.perf_counter() - t0

    def build(self, ckpt: str, audit: bool) -> dict:
        """The server's build, its head RPCs recorded when `audit`; where
        its weights came from, how the load went, each leaf's digest."""
        from ray_tpu_torch.serve import weight_store as ws
        from ray_tpu_torch.serve.disagg import _RpcAudit
        from ray_tpu_torch.serve.weight_store import _tree_flatten_keyed

        rpc = _RpcAudit()
        if audit:
            rpc.start()
        t0 = time.perf_counter()
        self.server = LLMServer(
            preset=PRESET, max_batch=4, max_seq_len=SERVE_WINDOW, seed=0,
            prefill_chunk_size=64, kv_block_size=16, kv_blocks=64,
            device=DEVICE, checkpoint=ckpt, cluster_prefix_cache=True)
        build_s = time.perf_counter() - t0
        reqs = [m for k, m in rpc.stop() if k == "req"]
        eng = self.server.engine
        return {"source": eng.weights_source, "cold_start_s":
                eng.cold_start_s, "build_s": build_s, "reqs": reqs,
                "load": dict(ws.get_store().last_load_stats),
                "digests": {k: _digest(v)
                            for k, v in _tree_flatten_keyed(eng.params)},
                "pid": os.getpid()}

    def weights_published(self) -> int:
        from ray_tpu_torch.serve import weight_store as ws

        return ws.get_store().stats()["published"]

    def serve(self, prompts) -> tuple:
        _zero_counts()
        tokens, logits = _rt_serve(self.server, prompts)
        return tokens, logits, _flash_counts()

    def prefix_published(self) -> int:
        return self.server.prefix_store.stats()["published"]

    def probe(self, ids) -> int:
        hit = self.server.prefix_store.lookup(list(ids), count=False)
        return 0 if hit is None else hit["n"]

    def prefix_serve(self, ids, audit: bool) -> dict:
        """One request; its prefill steps, TTFT, store hits and imported
        blocks, and head RPCs on the way when `audit`."""
        from ray_tpu_torch.serve.disagg import _RpcAudit

        eng, store = self.server.engine, self.server.prefix_store
        e0, s0 = eng.engine_stats(), store.stats()
        rpc = _RpcAudit()
        if audit:
            rpc.start()
        out = self.server({"prompt_ids": list(ids),
                           "max_tokens": RUNTIME_NEW})
        reqs = [m for k, m in rpc.stop() if k == "req"]
        e1, s1 = eng.engine_stats(), store.stats()
        return {"tokens": out["choices"][0]["token_ids"],
                "prefill_steps": e1["chunk_steps"] - e0["chunk_steps"],
                "ttft_s": e1["last_ttft_s"],
                "hits": s1["store_hits"] - s0["store_hits"],
                "blocks": e1["prefix_blocks_imported"]
                - e0["prefix_blocks_imported"], "reqs": reqs}


def _rt_cfg():
    """The configuration of phase 14's server (its window as max_seq_len)."""
    return gpt2.GPT2Config.preset(PRESET, max_seq_len=SERVE_WINDOW)


def _save_seeded_checkpoint(tmp: str) -> tuple:
    """The seeded GPT-2-125M params (phase 14's server's) written by
    gpt2.save_params: (path, parameter count, checkpoint bytes)."""
    cfg = _rt_cfg()
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    n = sum(p.size for p in gpt2.params_to_numpy(params).values())
    path = gpt2.save_params(os.path.join(tmp, "ckpt"), params, cfg)
    return path, n, os.path.getsize(os.path.join(path, "params.npz"))


def _objects_device(rt, card) -> dict:
    """(a): returns the owner's launches."""
    cfg = gpt2.GPT2Config.preset(PRESET)
    want = (cfg.n_layer, 0, 0)
    prompts = _rt_prompts()
    owner = rt.remote(ObjectsOwner).options(
        num_gpus=1, label_selector={"zone": "a"}).remote()
    near = rt.remote(ObjectsConsumer).options(
        label_selector={"zone": "a"}).remote()
    far = rt.remote(ObjectsConsumer).options(
        num_gpus=1, label_selector={"zone": "b"}).remote()
    rt.get([near.warm.remote(), far.warm.remote()], timeout=RUNTIME_SPAWN_S)
    t0 = time.perf_counter()
    ref = owner.produce.remote(prompts[0])
    rt.wait([ref], timeout=RUNTIME_SPAWN_S)
    produce_s = time.perf_counter() - t0
    stats = rt.get(owner.stats.remote(), timeout=60)
    if stats["launches"] is None:
        rt.get(ref, timeout=60)   # raises the owner's error
    box = {"r": ref}
    same = rt.get(owner.same.remote(box), timeout=60)
    want_dig = rt.get(owner.digests.remote(), timeout=120)
    used0, _ = rt.get(owner.arena.remote(), timeout=60)
    here = _obj_fetch(ref)
    there = rt.get(near.fetch.remote(box), timeout=600)
    staged_ab = rt.get(owner.stats.remote(), timeout=60)
    snap = rt.get(owner.snapshot.remote(box), timeout=60)
    used1, held1 = rt.get(owner.arena.remote(snap.get("oid", b"")),
                          timeout=60)
    far_out = rt.get(far.fetch.remote(box), timeout=600)
    staged_all = rt.get(owner.stats.remote(), timeout=60)
    leaf_bytes = sum(stats["leaf_bytes"])
    dev = _want_device()
    got = {"this process (head node)": here, "actor on node a": there,
           "actor on node b": far_out}
    log(f"[objects] (a) owner on node a "
        f"(num_gpus=1): prompt a's first-token logits through gpt2.forward "
        f"and phase 14's {RUNTIME_OBJECT_BYTES >> 20} MiB bf16 tensor kept "
        f"on its card in {produce_s:.2f} s from the call (its actor built "
        f"while the consumers warmed up), "
        f"launches K1/K2/K3 {stats['launches']} (want {want}); the owner's "
        f"own get returns the living tensors (identity, same data_ptr): "
        f"{same}")
    for where, r in got.items():
        log(f"[objects] (a) get in the {where} (pid {r['pid']}): leaves on "
            f"{sorted(set(r['devices'].values()))} (want {dev}), bit-equal "
            f"to the owner's {r['digests'] == want_dig}, snapshot pulled "
            f"across nodes {r['pulled']}, {r['ms']:.1f} ms = "
            f"{leaf_bytes / r['ms'] / 1e6:.3f} GB/s")
    log(f"[objects] (a) the owner staged {staged_ab['snapshots_staged']} "
        f"snapshot(s) for this process and node a's actor, "
        f"{staged_all['snapshots_staged']} after node b's too, with "
        f"{staged_all['d2h_copies']} device-to-host copies (one a CUDA "
        f"leaf); the snapshot: store kind {snap.get('kind')}, pickle meta "
        f"{snap.get('meta')} B, out-of-band buffers {snap.get('buffers')} "
        f"(want {stats['leaf_bytes']} B); node a's arena {used0} -> {used1} B used; phase 14's "
        f"same-node get of a host tensor {RUNTIME_REF['same_node_get_ms']:.3f}"
        f" ms, phase 15's cross-node pull {RUNTIME_REF['pull_gbps']:.3f} "
        f"GB/s; on {card}")
    _runtime_launch_check("objects owner", stats["launches"], want)
    if not all(same.values()):
        raise AssertionError("the owner's own get is not the living value")
    for where, r in got.items():
        if r["digests"] != want_dig or set(r["devices"].values()) != {dev}:
            raise AssertionError(f"the get in the {where} differs")
    if here["pulled"] is not True or far_out["pulled"] is not True \
            or there["pulled"] is not False:
        raise AssertionError("a get took the wrong route")
    on_card = torch.device(DEVICE).type == "cuda"
    if staged_ab["snapshots_staged"] != 1 or \
            staged_all["snapshots_staged"] != 1 or \
            staged_all["d2h_copies"] != (2 if on_card else 0):
        raise AssertionError("the owner staged more than one snapshot")
    if snap.get("meta", 1 << 20) >= 4096 or \
            sorted(snap["buffers"]) != stats["leaf_bytes"] or \
            RUNTIME_OBJECT_BYTES not in stats["leaf_bytes"]:
        raise AssertionError("the snapshot's bytes did not go out of band")
    # every ref dropped: the device store empties, the snapshot goes
    del ref, box
    rt.get(owner.drop.remote(), timeout=60)
    gc.collect()
    deadline = time.perf_counter() + OBJ_WAIT_S
    while True:
        left = rt.get(owner.stats.remote(), timeout=60)
        used2, held2 = rt.get(owner.arena.remote(snap["oid"]), timeout=60)
        if not left["device_objects"] and not left["cached_snapshots"] \
                and not held2:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"the device object was not freed: {left}")
        time.sleep(0.1)
    log(f"[objects] (a) every ref dropped: the owner's device store holds "
        f"{left['device_objects']}, cached snapshots {left['cached_snapshots']}"
        f", the arena holds the snapshot {held2}; node a's arena {used1} -> "
        f"{used2} B used (before staging {used0})")
    if used0 is not None and (held1 is not True or used2 > used0):
        raise AssertionError("the snapshot's arena bytes did not come back")
    for a in (owner, near, far):
        rt.kill(a)
    return {"objects owner forward": tuple(stats["launches"])}


def _objects_weights(rt, card, tmp) -> tuple:
    """(b) and (c): returns the replicas' launches and the replicas."""
    cfg = gpt2.GPT2Config.preset(PRESET)
    want = (cfg.n_layer, 0, 0)
    prompts = _rt_prompts()
    ref_tokens = RUNTIME_REF["tokens"]
    t0 = time.perf_counter()
    path, n_params, ck_bytes = _save_seeded_checkpoint(tmp)
    log(f"[objects] (b) checkpoint: {n_params} parameters of {PRESET}, "
        f"{4 * n_params} B in f32, params.npz {ck_bytes} B, written in "
        f"{time.perf_counter() - t0:.2f} s")
    r1 = rt.remote(PlaneReplica).options(
        num_gpus=1, label_selector={"zone": "a"}).remote()
    r2 = rt.remote(PlaneReplica).options(
        num_gpus=1, label_selector={"zone": "b"}).remote()
    b1 = rt.get(r1.build.remote(path, False), timeout=RUNTIME_SPAWN_S)
    tok1, log1, l1 = rt.get(r1.serve.remote(prompts), timeout=600)
    wait_s = rt.get(r2.wait_binding.remote(path), timeout=600)
    pub = rt.get(r1.weights_published.remote(), timeout=60)
    b2 = rt.get(r2.build.remote(path, True), timeout=RUNTIME_SPAWN_S)
    tok2, log2, l2 = rt.get(r2.serve.remote(prompts), timeout=600)
    ld = b2["load"]
    budget = ld.get("max_in_flight", 0) * ld.get("chunk_bytes", 0)
    resolve_s, load_s = ld.get("resolve_s", 0.0), ld.get("seconds", 0.0)
    same_leaves = b1["digests"] == b2["digests"]
    log(f"[objects] (b) R1 (node a, pid {b1['pid']}): weights from "
        f"{b1['source']}, cold start {b1['cold_start_s']:.2f} s, server "
        f"built in {b1['build_s']:.2f} s, published on the weight plane "
        f"({pub} publication(s)); R2's directory resolved it after "
        f"{wait_s:.2f} s")
    log(f"[objects] (b) R2 (node b, pid {b2['pid']}): weights from "
        f"{b2['source']}, head RPCs in its engine's build {b2['reqs']}; "
        f"resolve {resolve_s:.4f} s, pull {load_s - resolve_s:.2f} s, "
        f"cold start {b2['cold_start_s']:.2f} s, server built in "
        f"{b2['build_s']:.2f} s; {ld.get('bytes')} B = "
        f"{ld.get('bytes', 0) / max(load_s, 1e-9) / 1e9:.3f} GB/s; peak host bytes {ld.get('peak_host_bytes')} (budget "
        f"max_in_flight x chunk_bytes = {budget}); params bit-equal to R1's "
        f"leaf by leaf: {same_leaves} ({len(b2['digests'])} leaves); greedy "
        f"tokens of a and b equal to phase 14's: R1 {tok1 == ref_tokens}, R2 "
        f"{tok2 == ref_tokens}; first-token logits R2 vs R1 bit-equal "
        f"{torch.equal(log1, log2)}; launches K1/K2/K3 R1 {l1}, R2 {l2} "
        f"(want {want}); on {card}")
    if b1["source"] != "checkpoint" or b2["source"] != "p2p":
        raise AssertionError("the replicas' weights took the wrong route")
    if b2["reqs"]:
        raise AssertionError(f"R2's engine build made head RPCs: "
                             f"{b2['reqs']}")
    if not same_leaves or not 0 < ld["peak_host_bytes"] <= budget:
        raise AssertionError("R2's weights differ or overran the host budget")
    if tok1 != ref_tokens or tok2 != ref_tokens or not torch.equal(log1,
                                                                   log2):
        raise AssertionError("the replicas' output differs")
    _runtime_launch_check("weight plane R1", l1, want)
    _runtime_launch_check("weight plane R2", l2, want)

    # (c) the cluster prefix tier: R1 serves and publishes, R2 warm-starts
    shared = _prompt(4, OBJ_SHARED_LEN)
    p1 = rt.get(r1.prefix_serve.remote(shared, False), timeout=600)
    whole = (len(shared) - 1) // 16 * 16
    t0 = time.perf_counter()
    while (rt.get(r1.prefix_published.remote(), timeout=60) < 1
           or rt.get(r2.probe.remote(shared[:-1]), timeout=60) < whole):
        if time.perf_counter() - t0 > OBJ_WAIT_S:
            raise AssertionError("R1's prefix never reached R2's directory")
        time.sleep(0.05)
    covered = rt.get(r2.probe.remote(shared[:-1]), timeout=60)
    p2 = rt.get(r2.prefix_serve.remote(shared, True), timeout=600)
    log(f"[objects] (c) a {len(shared)}-token prompt: R1 prefilled it in "
        f"{p1['prefill_steps']} engine steps, TTFT {1e3 * p1['ttft_s']:.1f} "
        f"ms, and published it; R2's directory covered {covered} tokens "
        f"(whole 16-token blocks of len-1: {whole}) after "
        f"{time.perf_counter() - t0:.2f} s; R2: store hits {p2['hits']}, "
        f"blocks imported {p2['blocks']}, prefill steps "
        f"{p2['prefill_steps']}, TTFT {1e3 * p2['ttft_s']:.1f} ms, head RPCs "
        f"on its warm path {p2['reqs']}; tokens equal to R1's "
        f"{p2['tokens'] == p1['tokens']}")
    if (p2["hits"] != 1 or covered < whole or p2["blocks"] * 16 < whole
            or p2["prefill_steps"] >= p1["prefill_steps"]
            or p2["tokens"] != p1["tokens"] or p2["reqs"]):
        raise AssertionError("R2 did not warm-start from the prefix tier")
    for a in (r1, r2):
        rt.kill(a)
    return {"weight plane R1 serve": tuple(l1),
            "weight plane R2 (from peers) serve": tuple(l2)}


def phase_objects(card: str) -> dict:
    """The object plane's device half on the card (phase 16): device
    objects across processes and nodes, the weight plane's peer cold start
    and the cluster prefix tier. Returns the launches of the owner and of
    the replicas, each counted in its own process."""
    from ray_tpu_torch.cluster_utils import Cluster
    import ray_tpu_torch as rt

    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c = None
    tmp = tempfile.mkdtemp(prefix="phase16_")
    try:
        t0 = time.perf_counter()
        c = Cluster(num_cpus=0)
        for z in ("a", "b"):
            c.add_node(num_cpus=2, num_gpus=1, labels={"zone": z})
        c.connect()
        c.wait_for_nodes(3)
        log(f"[objects] head + daemons a, b up in "
            f"{time.perf_counter() - t0:.2f} s; cluster "
            f"{rt.cluster_resources()}; store isolation on")
        t0 = time.perf_counter()
        paths = _objects_device(rt, card)
        log(f"[objects] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.update(_objects_weights(rt, card, tmp))
        log(f"[objects] (b), (c) {time.perf_counter() - t0:.1f} s")
        return paths
    finally:
        try:
            rt.shutdown()
        finally:
            os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
            shutil.rmtree(tmp, ignore_errors=True)
            if c is not None:
                c.shutdown()
                left, segs = c.processes(), c.segments()
                log(f"[objects] shutdown: processes left {left}, segments "
                    f"left {segs}")
                if left or segs:
                    raise AssertionError("the cluster leaked")


# ------------------------------ phase 17: compiled DAGs and the 1F1B pipeline
# (a) a compiled DAG of two num_gpus=1 actors on one node: A runs the
# embedding and blocks 0-5 (its output a device object), B blocks 6-11
# and the unembedding; (b) the host-level 1F1B pipeline of four
# ChannelPipelineStage actors of 3 blocks each, joined by rings with device
# edges. The runtime advertises 4 GPUs on the one card. Each actor counts
# its own launches from 0.
COMPILED_ITERS = 20
PP_ACTORS = 4
PP_B = 8
PP_MB = 4
PP_LR = 0.05
PP_CAPACITY = 16 << 20   # above one microbatch's f32 activation, 6.29 MB
PP_COMPILED_STEPS = 3
# (b)'s params after its steps against the in-process run's: each leaf's
# largest gap within this share of its largest update in the in-process
# run (bf16 activations, microbatched against full-batch sums)
PP_PARAM_SHARE = 0.1


def _stage_params(params, n_stages: int) -> list:
    """GPT-2's params -> one untied tree a stage, on the CPU: the first
    stage holds wte and wpe, the last ln_f and its own copy of wte (GPT-2
    ties them; across actors each stage updates its own copy), each its
    share of the stacked blocks."""
    from ray_tpu_torch.utils.tree import tree_map

    L = params["blocks"]["attn"]["wqkv"].shape[0]
    per = L // n_stages
    out = []
    for s in range(n_stages):
        tree = {"blocks": tree_map(
            lambda a: a[s * per:(s + 1) * per].detach().cpu().clone(),
            params["blocks"])}
        if s == 0:
            tree["wte"] = params["wte"].detach().cpu().clone()
            tree["wpe"] = params["wpe"].detach().cpu().clone()
        if s == n_stages - 1:
            tree["ln_f"] = tree_map(lambda a: a.detach().cpu().clone(),
                                    params["ln_f"])
            tree["wte"] = params["wte"].detach().cpu().clone()
        out.append(tree)
    return out


def _gpt_stage_fn(cfg, pos: int, n_stages: int):
    """Stage `pos` of `n_stages` from models.gpt2: `embed` on the first,
    its blocks by `_block`, `unembed` on the last."""
    def fn(p, x):
        if pos == 0:
            x = gpt2.embed(p, x, cfg)
        for bp in gpt2._layers(p["blocks"]):
            x = gpt2._block(x, bp, cfg)
        if pos == n_stages - 1:
            x = gpt2.unembed(p, x, cfg)
        return x
    return fn


def _ce(logits, targets):
    from ray_tpu_torch.models import lm

    return lm.cross_entropy(logits, targets)


def _logits_out(logits) -> dict:
    """What (a) returns: the next-token logits of every row, and each
    position's f32 sum of its logits (a fingerprint of the whole [B, T,
    V] output)."""
    return {"last": logits[:, -1].cpu(),
            "sums": logits.float().sum(-1).cpu()}


class DagHalf:
    """(a)'s actor: one half of GPT-2-125M on its card."""

    def __init__(self, fn, params):
        from ray_tpu_torch.utils.tree import tree_map

        _no_tf32()
        self.fn = fn
        self.params = tree_map(lambda t: t.to(DEVICE), params)

    @ray_tpu_torch.method(tensor_transport="device")
    def hidden(self, tokens):
        with torch.no_grad():
            return self.fn(self.params, tokens.to(DEVICE))

    def head(self, x) -> dict:
        with torch.no_grad():
            return _logits_out(self.fn(self.params, x.to(DEVICE)))

    def zero(self) -> int:
        _zero_counts()
        return os.getpid()

    def counts(self) -> tuple:
        return _flash_counts()

    def store_len(self) -> int:
        from ray_tpu_torch.core.api import _global_client

        return len(_global_client().device_store)


def _pp_stage_class():
    """ChannelPipelineStage with the launch counts of its own process and
    the state of its device objects readable (the class the actors run;
    CompiledPipeline.build_stages makes the plain one)."""
    from ray_tpu_torch.parallel.pipeline import ChannelPipelineStage

    class CountedStage(ChannelPipelineStage):
        def __init__(self, *args, **kwargs):
            _no_tf32()
            super().__init__(*args, **kwargs)

        def zero(self) -> int:
            _zero_counts()
            return os.getpid()

        def counts(self) -> tuple:
            return _flash_counts()

        def card(self) -> str:
            """The uuid of the card this stage's process computes on."""
            if torch.device(DEVICE).type != "cuda":
                return "cpu"
            return str(torch.cuda.get_device_properties(
                torch.cuda.current_device()).uuid)

        def device_objects(self) -> tuple:
            """(entries in this process's device store, snapshots it has
            staged and still holds)."""
            from ray_tpu_torch.core.api import _global_client

            client = _global_client()
            return len(client.device_store), len(client._device_snapshots)

    return CountedStage


def _pp_launches(cfg, n_stages: int, M: int) -> list:
    """K1/K2/K3 launches a step in each stage's process, from the code:
    a non-last stage forwards each microbatch under no_grad (K1 a block)
    and runs it again under autograd in its backward (K1, then K2 and K3
    a block); the last stage's loss and gradients run each block once
    under autograd (K1, K2, K3)."""
    per = cfg.n_layer // n_stages
    return [((2 if s < n_stages - 1 else 1) * per * M, per * M, per * M)
            for s in range(n_stages)]


def _wait_devices_empty(stages, rt) -> list:
    deadline = time.perf_counter() + 60
    while True:
        left = rt.get([s.device_objects.remote() for s in stages],
                      timeout=60)
        if all(n == (0, 0) for n in left) \
                or time.perf_counter() > deadline:
            return left
        time.sleep(0.2)


def _util_sampler():
    """nvidia-smi's utilization.gpu every 100 ms (the share of each sample
    period in which a kernel ran on the card) until stopped: returns
    (stop() -> list of samples)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)

    def stop() -> list:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        return [int(x) for x in out.split() if x.strip().isdigit()]

    return stop


def _compiled_dag(rt, card, cfg, params) -> dict:
    """(a): returns its launches."""
    from ray_tpu_torch.dag import InputNode

    halves = _stage_params(params, 2)
    fns = [_gpt_stage_fn(cfg, i, 2) for i in range(2)]
    tokens = torch.randint(0, cfg.vocab_size, (FORWARD_B, SEQ),
                           generator=torch.Generator().manual_seed(17))
    with torch.no_grad():
        want = _logits_out(gpt2.forward(params, tokens.to(DEVICE), cfg))
    Half = rt.remote(num_gpus=1)(DagHalf)
    a, b = Half.remote(fns[0], halves[0]), Half.remote(fns[1], halves[1])
    pids = rt.get([a.zero.remote(), b.zero.remote()], timeout=RUNTIME_SPAWN_S)
    with InputNode() as inp:
        dag = b.head.bind(a.hidden.bind(inp))
    cdag = dag.experimental_compile(channel_capacity=PP_CAPACITY)
    secs = []
    try:
        t0 = time.perf_counter()
        first = cdag.execute(tokens).get(timeout=RUNTIME_SPAWN_S)
        bring_up = time.perf_counter() - t0
        outs = [first]
        for _ in range(COMPILED_ITERS):
            t0 = time.perf_counter()
            outs.append(cdag.execute(tokens).get(timeout=120))
            secs.append(time.perf_counter() - t0)
    finally:
        cdag.teardown()
    iters = COMPILED_ITERS + 1
    counts = rt.get([a.counts.remote(), b.counts.remote()], timeout=60)
    rings = [n for n in cdag.chan_names.values()
             if os.path.exists(f"/dev/shm/{n}")]
    deadline = time.perf_counter() + 30
    while (held := rt.get(a.store_len.remote(), timeout=60)) > 2 \
            and time.perf_counter() < deadline:
        time.sleep(0.2)
    equal = [torch.equal(o["last"], want["last"].cpu())
             and torch.equal(o["sums"], want["sums"].cpu()) for o in outs]
    # the same chain by chained actor calls (the device object passed on)
    rt.get([a.zero.remote(), b.zero.remote()], timeout=60)
    chained = []
    for _ in range(COMPILED_ITERS):
        t0 = time.perf_counter()
        out = rt.get(b.head.remote(a.hidden.remote(tokens)), timeout=120)
        chained.append(time.perf_counter() - t0)
    chained_equal = torch.equal(out["last"], want["last"].cpu())
    chained_counts = rt.get([a.counts.remote(), b.counts.remote()],
                            timeout=60)
    for h in (a, b):
        rt.kill(h)
    compiled_ms = 1e3 * statistics.median(secs)
    chained_ms = 1e3 * statistics.median(chained)
    want_each = (cfg.n_layer // 2 * iters, 0, 0)
    log(f"[compiled] (a) {PRESET} in 2 num_gpus=1 actors (pids {pids}), B="
        f"{FORWARD_B} T={SEQ}: bring-up and first iteration {bring_up:.2f} "
        f"s; median iteration {compiled_ms:.2f} ms compiled against "
        f"{chained_ms:.2f} ms by chained .remote calls ({COMPILED_ITERS} "
        f"each, {card}); results bit-equal to this process's forward: "
        f"{sum(equal)}/{len(equal)} compiled, chained {chained_equal}; "
        f"K1/K2/K3 in A and B over {iters} iterations {counts} (want "
        f"{want_each} each), chained {chained_counts}; A's device "
        f"store after teardown {held}; rings left {rings}")
    if not all(equal) or not chained_equal:
        raise AssertionError("(a): the compiled DAG's logits differ from "
                             "the one-process forward")
    for who, c in zip("AB", counts):
        _runtime_launch_check(f"(a) actor {who}", c, want_each)
    if held > 2:
        raise AssertionError(f"(a): A's device store holds {held} > 2")
    if rings:
        raise AssertionError(f"(a): rings left after teardown: {rings}")
    return {f"{PRESET} compiled DAG (2 actors)": tuple(
        sum(c[i] for c in counts) for i in range(3))}


def _pp_reference(cfg, stage_params, x, y, steps: int) -> tuple:
    """The same full-batch SGD steps in this process on the card, over the
    same untied stage functions: (losses, the params after the steps)."""
    from ray_tpu_torch.utils.tree import leaves, tree_map

    n = len(stage_params)
    fns = [_gpt_stage_fn(cfg, i, n) for i in range(n)]
    params = [tree_map(lambda t: t.to(DEVICE), p) for p in stage_params]
    x, y = x.to(DEVICE), y.to(DEVICE)
    losses = []
    for _ in range(steps):
        leafs = [tree_map(lambda t: t.detach().requires_grad_(True), p)
                 for p in params]
        h = x
        for fn, p in zip(fns, leafs):
            h = fn(p, h)
        loss = _ce(h, y)
        flat = [t for p in leafs for t in leaves(p)]
        grads = iter(torch.autograd.grad(loss, flat))
        params = [tree_map(lambda t: (t - PP_LR * next(grads)).detach(), p)
                  for p in leafs]
        losses.append(float(loss.detach()))
    return losses, [tree_map(lambda t: t.float().cpu().numpy(), p)
                    for p in params]


def _pipeline_run(rt, card, cfg, params) -> dict:
    """(b): returns its launches."""
    from ray_tpu_torch.parallel.pipeline import (CompiledPipeline,
                                                 eager_pipeline_step)
    from ray_tpu_torch.utils.tree import leaves

    F, M = PP_ACTORS, PP_MB
    stage_params = _stage_params(params, F)
    tokens = torch.randint(0, cfg.vocab_size, (PP_B, SEQ + 1),
                           generator=torch.Generator().manual_seed(18))
    x, y = tokens[:, :-1], tokens[:, 1:]
    steps = 1 + PP_COMPILED_STEPS + 1
    t0 = time.perf_counter()
    ref_losses, ref_params = _pp_reference(cfg, stage_params, x, y, steps)
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    Stage = rt.remote(num_gpus=1, max_concurrency=4)(_pp_stage_class())
    stages = [Stage.remote(_gpt_stage_fn(cfg, i, F), stage_params[i],
                           position=i, n_stages=F, lr=PP_LR,
                           loss_fn=_ce if i == F - 1 else None,
                           device=DEVICE)
              for i in range(F)]
    pids = rt.get([s.zero.remote() for s in stages],
                  timeout=RUNTIME_SPAWN_S)
    want = _pp_launches(cfg, F, M)

    def counts_since_zero() -> list:
        got = rt.get([s.counts.remote() for s in stages], timeout=60)
        rt.get([s.zero.remote() for s in stages], timeout=60)
        return [tuple(c) for c in got]

    losses, step_s = [], []
    t0 = time.perf_counter()
    losses.append(eager_pipeline_step(stages, x, y, M, timeout=600))
    step_s.append(time.perf_counter() - t0)
    eager1 = counts_since_zero()
    pipe = CompiledPipeline(stages, n_microbatches=M,
                            channel_capacity=PP_CAPACITY,
                            tensor_transport="device")
    stop = None
    try:
        for i in range(PP_COMPILED_STEPS):
            if i == 1:
                stop = _util_sampler()
            t0 = time.perf_counter()
            losses.append(pipe.step(x, y))
            step_s.append(time.perf_counter() - t0)
    finally:
        busy = stop() if stop is not None else []
        pipe.close()
    compiled = counts_since_zero()
    rings = [n for n in pipe.names.values()
             if os.path.exists(f"/dev/shm/{n}")]
    left = _wait_devices_empty(stages, rt)
    t0 = time.perf_counter()
    losses.append(eager_pipeline_step(stages, x, y, M, timeout=600))
    step_s.append(time.perf_counter() - t0)
    eager2 = counts_since_zero()
    got = rt.get([s.get_params.remote() for s in stages], timeout=120)
    for s in stages:
        rt.kill(s)
    loss_gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    init = [_np_tree(p) for p in stage_params]
    share = 0.0
    for g, r, p0 in zip(got, ref_params, init):
        for gl, rl, pl in zip(leaves(g), leaves(r), leaves(p0)):
            upd = float(abs(rl - pl).max())
            gap = float(abs(gl - rl).max())
            if upd > 0:
                share = max(share, gap / upd)
            elif gap > 0:
                share = float("inf")
    compiled_per_step = [tuple(v // PP_COMPILED_STEPS for v in c)
                         for c in compiled]
    log(f"[compiled] (b) {PRESET} 1F1B on {F} num_gpus=1 stage actors (pids "
        f"{pids}) of {cfg.n_layer // F} blocks, B={PP_B} T={SEQ} M={M}, "
        f"device edges, ring capacity {PP_CAPACITY} B: losses {losses} "
        f"against this process's full-batch steps {ref_losses} (largest gap "
        f"{loss_gap:.2e}, bound {TOL_TRAIN_LOSS}); params' largest gap "
        f"{share:.3e} of the largest update (bound {PP_PARAM_SHARE}); "
        f"K1/K2/K3 a step by stage: eager {eager1}, compiled "
        f"{compiled_per_step} (over {PP_COMPILED_STEPS} steps {compiled}), "
        f"eager again {eager2}, want {want}; step ms eager "
        f"{1e3 * step_s[0]:.1f} (first, cold) and {1e3 * step_s[-1]:.1f} "
        f"(warm), compiled {[round(1e3 * s, 1) for s in step_s[1:-1]]} "
        f"(first with the rings' bring-up); card busy share during compiled "
        f"steps 2-3 (nvidia-smi utilization.gpu, {len(busy)} samples) "
        f"{(sum(busy) / len(busy)) if busy else float('nan'):.1f} %; "
        f"in-process reference {ref_s:.1f} s; rings left {rings}; device "
        f"objects and snapshots left by stage {left}; {card}")
    if loss_gap > TOL_TRAIN_LOSS:
        raise AssertionError(f"(b): loss gap {loss_gap} > {TOL_TRAIN_LOSS}")
    if share > PP_PARAM_SHARE:
        raise AssertionError(f"(b): params gap {share} of the update > "
                             f"{PP_PARAM_SHARE}")
    for what, by_stage in (("eager step 1", eager1),
                           ("eager step 5", eager2),
                           (f"{PP_COMPILED_STEPS} compiled steps",
                            compiled)):
        scale = PP_COMPILED_STEPS if "compiled" in what else 1
        for i, (c, w) in enumerate(zip(by_stage, want)):
            _runtime_launch_check(f"(b) {what}, stage {i}", c,
                                  tuple(scale * v for v in w))
    if rings or any(n != (0, 0) for n in left):
        raise AssertionError(f"(b): left after close: rings {rings}, "
                             f"device objects {left}")
    total = [sum(c[i] for c in eager1 + compiled + eager2) for i in range(3)]
    return {f"{PRESET} 1F1B pipeline ({F} stage actors) train": tuple(total)}


def _np_tree(tree):
    from ray_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.float().numpy(), tree)


def compiled_pp_cards(card: str) -> dict:
    """(b)'s model and batch across cards: a cluster_utils daemon of one
    card each (CUDA_VISIBLE_DEVICES), under store isolation, one stage
    actor on each, so every ring crosses nodes (a remote reader through
    the writer's process); PP_COMPILED_STEPS compiled steps with host
    edges, then with device edges (a snapshot pulled across nodes), each
    step within TOL_TRAIN_LOSS of the in-process steps on one card. Run by
    tests/test_torch_cuda.py::test_compiled_pipeline_across_cards on four
    cards. Returns, by edge kind, the losses, step ms and the cards the
    stages ran on."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import _global_client
    from ray_tpu_torch.parallel.pipeline import CompiledPipeline

    F, M = PP_ACTORS, PP_MB
    on_card = torch.device(DEVICE).type == "cuda"
    cfg = gpt2.GPT2Config.preset(PRESET, attn_impl="flash", remat=False)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    stage_params = _stage_params(params, F)
    del params
    tokens = torch.randint(0, cfg.vocab_size, (PP_B, SEQ + 1),
                           generator=torch.Generator().manual_seed(18))
    x, y = tokens[:, :-1], tokens[:, 1:]
    ref_losses, _ = _pp_reference(cfg, stage_params, x, y, PP_COMPILED_STEPS)
    if on_card:
        torch.cuda.empty_cache()
    os.environ["RAY_TPU_STORE_ISOLATION"] = "1"
    c, out = None, {}
    try:
        c = Cluster(num_cpus=0)
        for i in range(F):
            c.add_node(num_cpus=2, num_gpus=1, labels={"card": str(i)},
                       env={"CUDA_VISIBLE_DEVICES": str(i)} if on_card
                       else None)
        c.connect()
        c.wait_for_nodes(F + 1)
        Stage = rt.remote(num_gpus=1, max_concurrency=4)(_pp_stage_class())
        client = _global_client()
        for kind, transport in (("host", None), ("device", "device")):
            stages = [Stage.options(label_selector={"card": str(i)}).remote(
                _gpt_stage_fn(cfg, i, F), stage_params[i], position=i,
                n_stages=F, lr=PP_LR, loss_fn=_ce if i == F - 1 else None,
                device=DEVICE) for i in range(F)]
            cards = rt.get([s.card.remote() for s in stages],
                           timeout=RUNTIME_SPAWN_S)
            nodes = [client.head_request(
                "get_actor_address", actor_id=s._actor_id.binary())[
                    "node_id"] for s in stages]
            pipe = CompiledPipeline(stages, n_microbatches=M,
                                    channel_capacity=PP_CAPACITY,
                                    tensor_transport=transport)
            losses, secs = [], []
            try:
                for _ in range(PP_COMPILED_STEPS):
                    t0 = time.perf_counter()
                    losses.append(pipe.step(x, y))
                    secs.append(time.perf_counter() - t0)
            finally:
                pipe.close()
            rings = [n for n in pipe.names.values()
                     if os.path.exists(f"/dev/shm/{n}")]
            for s in stages:
                rt.kill(s)
            gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
            out[kind] = {"losses": losses, "ms": [1e3 * t for t in secs],
                         "cards": cards, "nodes": nodes, "gap": gap,
                         "rings": rings}
            log(f"[compiled across cards] {PRESET} 1F1B, {F} stages on {F} "
                f"nodes of one card each, {kind} edges: losses {losses} "
                f"against one card's {ref_losses} (largest gap {gap:.2e}, "
                f"bound {TOL_TRAIN_LOSS}); step ms "
                f"{[round(v, 1) for v in out[kind]['ms']]} (the first with "
                f"the rings' bring-up); cards {cards}; distinct nodes "
                f"{len(set(nodes))}; rings left {rings}; {card}")
    finally:
        rt.shutdown()
        os.environ.pop("RAY_TPU_STORE_ISOLATION", None)
        if c is not None:
            c.shutdown()
            left, segs = c.processes(), c.segments()
            log(f"[compiled across cards] shutdown: processes left {left}, "
                f"segments left {segs}")
            if left or segs:
                raise AssertionError("the cluster leaked")
    for kind, r in out.items():
        if r["gap"] > TOL_TRAIN_LOSS:
            raise AssertionError(f"{kind} edges: loss gap {r['gap']}")
        if len(set(r["nodes"])) != F or r["rings"]:
            raise AssertionError(f"{kind} edges: nodes {r['nodes']}, rings "
                                 f"left {r['rings']}")
        if on_card and len(set(r["cards"])) != F:
            raise AssertionError(f"{kind} edges: cards {r['cards']}")
    return out


def phase_compiled(card: str) -> dict:
    """Compiled DAGs and the channel-driven 1F1B pipeline on the card
    (phase 17). Returns each run's launches, counted in its actors'
    processes."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api

    cfg = gpt2.GPT2Config.preset(PRESET, attn_impl="flash", remat=False)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    t0 = time.perf_counter()
    info = rt.init(num_cpus=RUNTIME_CPUS + 4, num_gpus=PP_ACTORS)
    session = info["session"]
    log(f"[compiled] runtime up in {time.perf_counter() - t0:.2f} s, "
        f"cluster {rt.cluster_resources()} (the one card advertised as "
        f"{PP_ACTORS} GPUs)")
    try:
        t0 = time.perf_counter()
        paths = _compiled_dag(rt, card, cfg, params)
        log(f"[compiled] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.update(_pipeline_run(rt, card, cfg, params))
        log(f"[compiled] (b) {time.perf_counter() - t0:.1f} s")
        return paths
    finally:
        _shutdown_runtime(rt, rt_api)
        left = glob.glob(f"/dev/shm/rtpt_*{session[:8]}*") \
            + glob.glob("/dev/shm/rtpt_chan_*") \
            + glob.glob("/dev/shm/rtpt_pp_*")
        log(f"[compiled] shutdown: segments left {left}")
        if left:
            raise AssertionError(f"phase 17 left segments {left}")


# ------------------------------------- phase 18: the serve control plane
# One node daemon advertising 2 GPUs on the one card, under a head with
# none. (a) build_llm_deployment at phase 14's engine configuration on two
# num_gpus=1 replicas behind the HTTP proxy, then build_openai_app on one
# replica for an SSE stream; (b)+(c) a scorer deployment (num_gpus=1,
# @serve.batch) running gpt2.forward (K1 once a layer) at
# T=SERVE_SCORE_T, autoscaled with min_replicas=0: parked when deployed,
# woken by the first of SERVE_SCORE_N concurrent HTTP requests, parked
# again once idle. The scorer counts its own launches from 0.
SERVE_SCORE_T = 1024
SERVE_SCORE_BATCH = 4
SERVE_SCORE_N = 8
SERVE_WAIT_S = 300        # this phase's own deadline for a cold answer
SERVE_PARK_S = 120        # for the idle scorer to park again
SERVE_TIMED = 3           # warm whole requests timed on each route
SERVE_TIMED_SMALL = 10    # warm one-token requests timed on each route


class ServeScorer:
    """(b) The scorer deployment's callable: gpt2.forward (flash: K1 once
    a layer) on the seeded GPT-2-125M params, batched by @serve.batch.
    Each answer carries its request's last-position logits (float32
    bytes, base64) and this replica's counts after the forward that
    served it."""

    def __init__(self):
        _no_tf32()
        self.cfg = gpt2.GPT2Config.preset(PRESET, attn_impl="flash",
                                          remat=False)
        self.params = gpt2.init_params(torch.Generator().manual_seed(0),
                                       self.cfg, DEVICE)
        self.forwards = 0
        _zero_counts()

    @serve.batch(max_batch_size=SERVE_SCORE_BATCH, batch_wait_timeout_s=0.1)
    def __call__(self, requests):
        import base64

        ids = torch.tensor([r.json["tokens"] for r in requests],
                           device=DEVICE)
        with torch.inference_mode():
            last = gpt2.forward(self.params, ids, self.cfg)[:, -1]
            last = last.float().cpu()
        self.forwards += 1
        counts = _flash_counts()
        return [{"logits": base64.b64encode(row.numpy().tobytes()).decode(),
                 "batch": len(requests), "forwards": self.forwards,
                 "launches": counts, "pid": os.getpid()} for row in last]


def _post(url: str, body: dict, timeout: float = SERVE_WAIT_S) -> tuple:
    """(status, content type, body bytes, seconds) of one JSON POST."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
        return (r.status, r.headers.get("Content-Type"), raw,
                time.perf_counter() - t0)


def _sse(url: str, body: dict) -> tuple:
    """(seconds to the first event with text, the streamed text, the
    number of events, the content type) of an SSE request."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first, text, events = None, "", []
    with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
        ctype = r.headers.get("Content-Type")
        for line in r:
            line = line.decode().rstrip("\n")
            if not line.startswith("data: "):
                continue
            events.append(line[len("data: "):])
            if events[-1] == "[DONE]":
                break
            delta = json.loads(events[-1])["choices"][0]["text"]
            if delta and first is None:
                first = time.perf_counter() - t0
            text += delta
    if events[-1:] != ["[DONE]"]:
        raise AssertionError(f"the SSE stream did not end with [DONE]: "
                             f"{events[-3:]}")
    return first, text, len(events), ctype


def _concurrent(fn, args_list) -> list:
    """fn(*args) for each args in its own thread: [(result, error)]."""
    out = [None] * len(args_list)

    def run(i, args):
        try:
            out[i] = (fn(*args), None)
        except Exception as e:   # reported by the caller's gate
            out[i] = (None, e)

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT_S + 60)
    return out


def _running(serve_api, name: str) -> int:
    return serve_api.status().get(name, {}).get("running", 0)


def _inproc_ttft(server, prompt) -> tuple:
    """(TTFT s, whole request s, tokens) of one stream of the in-process
    server."""
    eng = server.engine
    t0 = time.perf_counter()
    sid = eng.start_stream(prompt_ids=prompt, max_tokens=RUNTIME_NEW)
    first, toks, cursor = None, [], 0
    while True:
        part = eng.stream_next(sid, cursor)
        if part["token_ids"] and first is None:
            first = time.perf_counter() - t0
        toks += part["token_ids"]
        cursor = part["cursor"]
        if part["done"]:
            return first, time.perf_counter() - t0, toks


def _serve_llm(rt, serve_api, card: str, port: int) -> None:
    """(a): the LLM app on two replicas through HTTP and a handle, then
    the OpenAI app's SSE stream; timed against this process's server."""
    from ray_tpu_torch.serve.llm import (ByteTokenizer, build_llm_deployment,
                                         build_openai_app)

    prompts = _rt_prompts()
    ref = RUNTIME_REF["tokens"]
    engine = dict(max_batch=4, max_seq_len=SERVE_WINDOW, seed=0,
                  prefill_chunk_size=64, kv_block_size=16, kv_blocks=64,
                  device=DEVICE)
    url = f"http://127.0.0.1:{port}"
    bodies = [{"prompt_ids": p, "max_tokens": RUNTIME_NEW} for p in prompts]
    t0 = time.perf_counter()
    h = serve_api.run(build_llm_deployment(PRESET, num_replicas=2, num_gpus=1,
                                           name="llm", **engine),
                      route_prefix="/llm")
    # a and b at once through the proxy, twice: the router's in-flight
    # counts put one on each replica, so each request runs alone in its
    # engine as in the driver's server (a batch of two may round
    # differently); the first wave pays the replicas' cold start
    answers = _concurrent(lambda b: _post(f"{url}/llm", b),
                          [(b,) for b in bodies])
    cold_s = time.perf_counter() - t0
    answers += _concurrent(lambda b: _post(f"{url}/llm", b),
                           [(b,) for b in bodies])
    errors = [e for _, e in answers if e is not None]
    if errors:
        raise AssertionError(f"(a) HTTP requests failed: {errors}")
    http_tokens = [json.loads(r[2])["choices"][0]["token_ids"]
                   for r, _ in answers]
    ctypes_ = {r[1] for r, _ in answers}
    handle_tokens = [h.remote(b).result(timeout=SERVE_WAIT_S)["choices"][0]
                     ["token_ids"] for b in bodies]
    table = rt.get(rt.get_actor("serve-controller").get_routing_table.remote(
        "llm"), timeout=60)
    totals = {tag: rt.get(r.check_health.remote(), timeout=60)["total"]
              for tag, r in table["replicas"].items()}
    http_ok = all(t == ref[i % 2] for i, t in enumerate(http_tokens))
    handle_ok = handle_tokens == ref
    log(f"[serve] (a) build_llm_deployment({PRESET}) on 2 num_gpus=1 "
        f"replicas: deployed and a, b answered at once through the proxy in "
        f"{cold_s:.2f} s (worker start, torch import, CUDA context and "
        f"build included); tokens of a, b, then a, b again over HTTP equal to phase "
        f"14's driver-side server: {http_ok} (content type {ctypes_}); "
        f"through a DeploymentHandle: {handle_ok}; requests answered by "
        f"replica {totals}")
    if not (http_ok and handle_ok):
        raise AssertionError("(a) tokens differ from the driver's server")
    if len(totals) != 2 or min(totals.values()) < 1:
        raise AssertionError(f"(a) not both replicas answered: {totals}")

    # warm timings, the routes in turn: a one-token request (the route's
    # own cost) and prompt a's whole request, through the proxy, a handle
    # and the server in this process
    server = _rt_server()
    try:
        small = {"prompt_ids": prompts[0][:16], "max_tokens": 1}
        routes = {"http": lambda b: _post(f"{url}/llm", b),
                  "handle": lambda b: h.remote(b).result(
                      timeout=SERVE_WAIT_S),
                  "in-process": server}
        ms = {(name, kind): [] for name in routes for kind in ("1", "a")}
        for fn in routes.values():
            fn(small)
        for body, kind, n in ((small, "1", SERVE_TIMED_SMALL),
                              (bodies[0], "a", SERVE_TIMED)):
            for _ in range(n):
                for name, fn in routes.items():
                    t0 = time.perf_counter()
                    fn(body)
                    ms[name, kind].append(1e3 * (time.perf_counter() - t0))
        med = {k: statistics.median(v) for k, v in ms.items()}
        ttft_in, whole_in, toks_in = _inproc_ttft(server, prompts[0])
    finally:
        server.shutdown()
    serve_api.delete("llm")
    log(f"[serve] (a) warm, routes in turn: a one-token request (16-token "
        f"prompt) x {SERVE_TIMED_SMALL}, median ms HTTP "
        f"{med['http', '1']:.3f}, handle {med['handle', '1']:.3f}, "
        f"in-process {med['in-process', '1']:.3f}: HTTP over in-process "
        f"{med['http', '1'] - med['in-process', '1']:.3f} ms a request, "
        f"handle over in-process {med['handle', '1'] - med['in-process', '1']:.3f}"
        f"; prompt a ({len(prompts[0])} tokens, {RUNTIME_NEW} new) x "
        f"{SERVE_TIMED}, ms HTTP {[round(x, 2) for x in ms['http', 'a']]}, "
        f"handle {[round(x, 2) for x in ms['handle', 'a']]}, in-process "
        f"{[round(x, 2) for x in ms['in-process', 'a']]}: tok/s HTTP "
        f"{RUNTIME_NEW / med['http', 'a'] * 1e3:.1f}, in-process "
        f"{RUNTIME_NEW / med['in-process', 'a'] * 1e3:.1f}; in-process TTFT "
        f"{ttft_in * 1e3:.2f} ms; {card}")
    if toks_in != ref[0]:
        raise AssertionError("(a) the in-process stream's tokens differ")

    # the OpenAI app on one replica: an SSE stream of prompt a
    t0 = time.perf_counter()
    serve_api.run(build_openai_app(PRESET, num_gpus=1, model_id=PRESET,
                                   **engine), route_prefix="/v1")
    body = {"prompt_ids": prompts[0], "max_tokens": RUNTIME_NEW,
            "temperature": 0.0}
    status, _, raw, _ = _post(f"{url}/v1/completions", body)
    cold_s = time.perf_counter() - t0
    whole = json.loads(raw)["choices"][0]["text"]
    ttfts, text, n_events, ctype = [], None, 0, None
    for _ in range(1 + SERVE_TIMED):
        first, text, n_events, ctype = _sse(f"{url}/v1/completions", body)
        ttfts.append(1e3 * first)
    want = ByteTokenizer().decode(ref[0])
    serve_api.delete(f"openai-{PRESET}")
    log(f"[serve] (a) build_openai_app on 1 replica: first completion "
        f"{cold_s:.2f} s after deploy (cold); SSE of prompt a: content "
        f"type {ctype}, {n_events} events ending [DONE], streamed text "
        f"equal to the decode of phase 14's tokens: {text == want}, to the "
        f"non-streamed completion: {text == whole}; TTFT through the proxy "
        f"ms {[round(t, 2) for t in ttfts]} (first cold-ish) against "
        f"{ttft_in * 1e3:.2f} in-process; {card}")
    if status != 200 or not ctype.startswith("text/event-stream"):
        raise AssertionError("(a) the SSE request failed")
    if text != want or whole != want:
        raise AssertionError("(a) the streamed text differs from phase "
                             "14's tokens")


def _serve_scorer(rt, serve_api, card: str, port: int) -> dict:
    """(b)+(c): the scorer parked, woken by a burst of concurrent HTTP
    requests, batched, and parked again. Returns its launches, counted in
    its own process."""
    import base64

    cfg = gpt2.GPT2Config.preset(PRESET, attn_impl="flash", remat=False)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    prompts = [_prompt(100 + i, SERVE_SCORE_T) for i in range(SERVE_SCORE_N)]
    with torch.inference_mode():
        refs = [gpt2.forward(params, torch.tensor([p], device=DEVICE),
                             cfg)[0, -1].float().cpu() for p in prompts]
    del params
    dep = serve_api.deployment(
        ServeScorer, name="scorer",
        ray_actor_options={"num_cpus": 1, "num_gpus": 1},
        max_ongoing_requests=2 * SERVE_SCORE_N,
        autoscaling_config=serve_api.AutoscalingConfig(
            min_replicas=0, max_replicas=1,
            target_ongoing_requests=SERVE_SCORE_BATCH,
            signal_staleness_s=2.0))
    serve_api.run(dep.bind(), route_prefix="/score")
    time.sleep(2.0)
    seen = [_running(serve_api, "scorer")]
    if seen != [0]:
        raise AssertionError(f"(c) the scorer is not parked: {seen}")
    url = f"http://127.0.0.1:{port}/score"
    t0 = time.perf_counter()
    done = []
    answers = [None] * SERVE_SCORE_N

    def one(i):
        answers[i] = _post(url, {"tokens": prompts[i]})
        done.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(SERVE_SCORE_N)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        n = _running(serve_api, "scorer")
        if n != seen[-1]:
            seen.append(n)
        time.sleep(0.25)
    burst_s = time.perf_counter() - t0
    if None in answers or len(done) != SERVE_SCORE_N:
        raise AssertionError("(b) a scorer request failed")
    deadline = time.perf_counter() + SERVE_PARK_S
    while time.perf_counter() < deadline:
        n = _running(serve_api, "scorer")
        if n != seen[-1]:
            seen.append(n)
        if n == 0:
            break
        time.sleep(0.25)
    park_s = time.perf_counter() - t0 - burst_s
    outs = [json.loads(a[2]) for a in answers]
    gaps = [float((torch.frombuffer(bytearray(base64.b64decode(o["logits"])),
                                    dtype=torch.float32) - r).abs().max())
            for o, r in zip(outs, refs)]
    forwards = max(o["forwards"] for o in outs)
    final = next(tuple(o["launches"]) for o in outs
                 if o["forwards"] == forwards)
    batches = sorted(o["batch"] for o in outs)
    log(f"[serve] (b)+(c) scorer (gpt2.forward at T={SERVE_SCORE_T}, "
        f"@serve.batch max {SERVE_SCORE_BATCH}, min_replicas=0): replicas "
        f"seen {seen}; {SERVE_SCORE_N} concurrent HTTP requests on the "
        f"parked deployment: cold first answer {min(done):.2f} s (the wake: "
        f"worker start, torch import, CUDA context, model build), all in "
        f"{burst_s:.2f} s, answered by pids {sorted({o['pid'] for o in outs})}"
        f"; parked again {park_s:.2f} s after the burst; batch sizes "
        f"{batches}, forwards {forwards}; logits vs this process's B=1 "
        f"forward max |d| {max(gaps):.4g} (tol {TOL_LOGITS}); launches "
        f"K1/K2/K3 in the replica {final} (want "
        f"{(cfg.n_layer * forwards, 0, 0)}); {card}")
    if seen != [0, 1, 0]:
        raise AssertionError(f"(c) replicas went {seen}, not [0, 1, 0]")
    if max(gaps) > TOL_LOGITS:
        raise AssertionError("(b) the scorer's logits differ")
    if max(batches) < 2:
        raise AssertionError("(b) no forward batched two requests")
    for o in outs:
        _runtime_launch_check("scorer replica", o["launches"],
                              (cfg.n_layer * o["forwards"], 0, 0))
    return {f"{PRESET} serve scorer (batched, woken from zero)": final}


def phase_serve_plane(card: str) -> dict:
    """The serve control plane on the card (phase 18). Returns the
    scorer's launches, counted in its own process."""
    from ray_tpu_torch.cluster_utils import Cluster
    import ray_tpu_torch as rt

    c = None
    try:
        t0 = time.perf_counter()
        c = Cluster(num_cpus=0)
        c.add_node(num_cpus=4, num_gpus=2)
        c.connect()
        c.wait_for_nodes(2)
        port = serve.start()
        log(f"[serve] head (no GPU) + a daemon of 2 GPUs on the one card up, "
            f"HTTP proxy on port {port}, in {time.perf_counter() - t0:.2f} "
            f"s; cluster {rt.cluster_resources()}")
        t0 = time.perf_counter()
        _serve_llm(rt, serve, card, port)
        log(f"[serve] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths = _serve_scorer(rt, serve, card, port)
        log(f"[serve] (b)+(c) {time.perf_counter() - t0:.1f} s")
        return paths
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
        finally:
            if c is not None:
                c.shutdown()
                left, segs = c.processes(), c.segments()
                log(f"[serve] shutdown: processes left {left}, segments "
                    f"left {segs}")
                if left or segs:
                    raise AssertionError("the cluster leaked")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] allow_tf32 = False for cuda.matmul and cudnn")
    card = gpu_line()
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card: {card}")
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1 = phase_kernels(gen)
    bwd = phase_backward(gen)
    phase_sweep(gen)
    torch.cuda.empty_cache()   # the main paths start from an empty cache

    # the inference main path: counts from 0, read right after
    _zero_counts()
    with torch.no_grad():
        phase_forward(torch.Generator().manual_seed(0))
    phase_serve(card)
    log(f"[inference path] K1/K2/K3 launches {_flash_counts()}")
    if fa.flash_attention.launches < 1:
        raise AssertionError("the inference path never launched K1")
    paths = {"gpt2-125m inference": _flash_counts()}

    # the OpenAI server with LoRA adapters, from counts at 0
    _zero_counts()
    t0 = time.perf_counter()
    phase_openai(card)
    paths["gpt2-125m openai+lora"] = _flash_counts()
    log(f"[openai path] K1/K2/K3 launches {_flash_counts()}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if fa.flash_attention.launches < 1:
        raise AssertionError("the OpenAI path never launched K1")
    torch.cuda.empty_cache()

    # the training main path: phase_train zeroes the counts
    launches = phase_train(card)
    paths["gpt2-125m train"] = launches
    torch.cuda.empty_cache()

    # data parallel on torch.distributed: (b)'s run counts from 0
    paths["gpt2-125m dp train"] = phase_dp(card)
    torch.cuda.empty_cache()

    # the named mesh on DTensor: (a)'s and (c)'s runs each count from 0
    paths.update(phase_mesh(card))
    torch.cuda.empty_cache()

    # the Llama and MoE paths, each from counts at 0
    _zero_counts()
    with torch.no_grad():
        phase_llama_infer(card)
    paths[f"{LLAMA_INFER} inference"] = _flash_counts()
    if fa.flash_attention.launches < 1:
        raise AssertionError("the llama inference path never launched K1")
    torch.cuda.empty_cache()
    paths[f"{LLAMA_TRAIN} train"] = phase_llama_train(card)
    torch.cuda.empty_cache()
    _zero_counts()
    paths[f"{MOE_PRESET} {MOE_LAYERS}-layer train"] = phase_moe(card)
    torch.cuda.empty_cache()

    # ring attention's schedule on virtual ranks, then a TrainState saved
    # and restored: each path from counts at 0
    ring_paths, ring_chunk, ring_ragged = phase_ring(gen, card)
    paths.update(ring_paths)
    torch.cuda.empty_cache()
    paths[f"{PRESET} checkpoint save/restore"] = phase_checkpoint(card)
    torch.cuda.empty_cache()

    # the GPipe pipeline on virtual stages: counts from 0 in the phase
    t0 = time.perf_counter()
    paths[f"{PRESET} pipeline pp={PIPE_F} (virtual stages) train"] = \
        phase_pipeline(card)
    log(f"[pipeline] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # the compositions on one card: the composed hierarchical step counts
    # from 0 in the phase; the tp engine launches no kernel
    t0 = time.perf_counter()
    paths[f"{PRESET} hierarchical 7-D world 1 train"] = phase_compose(card)
    log(f"[compose] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # the runtime: an actor's and a task's launches, each counted in its
    # own process from 0
    t0 = time.perf_counter()
    paths.update(phase_runtime(card))
    log(f"[runtime] phase {time.perf_counter() - t0:.1f} s; script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # the runtime across nodes: the actor's launches, counted in its own
    # process from 0, on N1 and after its move to N2
    t0 = time.perf_counter()
    paths.update(phase_multinode(card))
    log(f"[multinode] phase {time.perf_counter() - t0:.1f} s; script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # the object plane's device half: the owner's and the replicas'
    # launches, each counted in its own process from 0
    t0 = time.perf_counter()
    paths.update(phase_objects(card))
    log(f"[objects] phase {time.perf_counter() - t0:.1f} s; script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # compiled DAGs and the 1F1B pipeline: each actor's launches, counted
    # in its own process from 0
    t0 = time.perf_counter()
    paths.update(phase_compiled(card))
    log(f"[compiled] phase {time.perf_counter() - t0:.1f} s; script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # the serve control plane: the scorer's launches, counted in its own
    # process from 0
    t0 = time.perf_counter()
    paths.update(phase_serve_plane(card))
    log(f"[serve] phase {time.perf_counter() - t0:.1f} s; script so far "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[paths] K1/K2/K3 launches by path: {paths}")

    # each kernel's records by case: the GPT-2 training path's fill the
    # contract's keys, the Llama paths' go under "llama_shapes"
    rows = [("flash_fwd (K1)", "flash_fwd.cu", 62, k1),
            ("flash_bwd_dq (K2)", "flash_bwd.cu", 141,
             {n: r[0] for n, r in bwd.items()}),
            ("flash_bwd_dkv (K3)", "flash_bwd.cu", 175,
             {n: r[1] for n, r in bwd.items()})]
    kernels = [
        dict(name=name, route="cuda", source=f"ray_tpu_torch/csrc/{cu}",
             replaces=f"ray_tpu/ops/flash_attention.py:{line}",
             launches=launches[i], **by_case["train-path"],
             launches_by_path={p: c[i] for p, c in paths.items()},
             llama_shapes={n: by_case[n] for n in LLAMA_SHAPES},
             ring_chunk=ring_chunk[i], ring_ragged_chunk=ring_ragged[i],
             head_dim_80=by_case["dh80"])
        for i, (name, cu, line, by_case) in enumerate(rows)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
