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
6. GPT-2-125M training at full width (bench.py's defaults: B=24, T=1024,
   remat "dots", flash attention) through compile_gpt2_train: exact kernel
   launches per step, a falling loss on a repeated batch, the first steps
   equal to the dense path's, step time, tokens/s and MFU.
Phases 4-5 (inference) and phase 6 (training) are the main paths: every
kernel's launch count is set to 0 before each and read right after. The
line before the last lists the kernels as JSON, with the training path's
counts; the last line is {"ok": true, "device": {...}}. Any failure raises
and the script exits non-zero without that line. Needs one CUDA card;
imports nothing of JAX.

TF32 is off for matmuls and cuDNN (set below), so float32 products are full
float32 and the f32 comparisons are meaningful.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer
from ray_tpu_torch.train import spmd

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

# (name, B, H, T, Dh, dtype, causal, model_layout). model_layout: q, k, v
# are views split from one [B, T, 3*H*Dh] tensor and dO is the transposed
# view of a [B, T, H*Dh] gradient, as gpt2._attention and autograd hand them
# to the kernels; otherwise all four are contiguous. The first case is the
# training main path's own shape and layout (its K1, K2, K3 records fill the
# kernels line); the second is the forward's.
KERNEL_CASES = [
    ("train-path", 24, 12, 1024, 64, torch.bfloat16, True, True),
    ("forward-path", 4, 12, 1024, 64, torch.bfloat16, True, True),
    ("b4-t1024", 4, 12, 1024, 64, torch.bfloat16, True, False),
    ("b8-t1024", 8, 12, 1024, 64, torch.bfloat16, True, False),
    ("b2-t2048", 2, 12, 2048, 64, torch.bfloat16, True, False),
    ("non-causal", 4, 12, 1024, 64, torch.bfloat16, False, False),
    ("f32", 2, 12, 1024, 64, torch.float32, True, False),
    ("dh32", 2, 4, 256, 32, torch.bfloat16, True, False),
    ("dh128-f32", 2, 4, 256, 128, torch.float32, False, False),
    ("ragged-t100", 4, 12, 100, 64, torch.bfloat16, True, False),
    ("dh128", 2, 12, 1024, 128, torch.bfloat16, True, False),
    ("dh32-non-causal", 2, 4, 256, 32, torch.bfloat16, False, False),
]


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
# the training main path's K1, K2 and K3 instantiations: they must not spill
MAIN_PATH_MMA = ("flash_fwd_mma_kernel<bf16, Dh=64>",
                 "flash_bwd_dq_mma_kernel<bf16, Dh=64>",
                 "flash_bwd_dkv_mma_kernel<bf16, Dh=64>")
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
    instantiation of K1, K2 or K3 has no tensor-core instruction, or if the
    main path's (bf16, Dh=64) K1, K2 or K3 spills."""
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


def _case_inputs(gen, B, H, T, Dh, dtype, model_layout) -> list:
    """q, k, v, dO [B, H, T, Dh] of a kernel case (see KERNEL_CASES)."""
    if not model_layout:
        return [torch.randn((B, H, T, Dh), generator=gen, device=DEVICE)
                .to(dtype) for _ in range(4)]
    D = H * Dh
    qkv = torch.randn((B, T, 3 * D), generator=gen, device=DEVICE).to(dtype)
    do = torch.randn((B, T, D), generator=gen, device=DEVICE).to(dtype)
    return [t.reshape(B, T, H, Dh).transpose(1, 2)
            for t in (*qkv.split(D, dim=-1), do)]


def _case_label(B, H, T, Dh, dtype, causal, model_layout) -> str:
    return (f"B={B} H={H} T={T} Dh={Dh} {str(dtype)[6:]} causal={causal} "
            f"{'model views' if model_layout else 'contiguous'}")


def phase_kernels(gen: torch.Generator) -> dict:
    """K1 against flash_attention_reference and mha_reference; returns the
    first case's record (the training path's shape)."""
    main = None
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
        if main is None:
            main = rec
    return main


def _grads(fn, inputs, do):
    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, do)


def phase_backward(gen: torch.Generator) -> tuple:
    """K2 and K3 against their plain versions, and K1+K2+K3 gradients
    against autograd through mha_reference; returns the first case's (the
    training path's shape) records of K2 and K3."""
    recs = None
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
        # the library yardstick for K2+K3 together: SDPA's backward alone
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), do, retain_graph=True))
        del o
        b2 = dq_bound(B, H, T, T, Dh, dtype, causal)
        b3 = dkv_bound(B, H, T, T, Dh, dtype, causal)
        log(f"[K2/K3 {name}] {_case_label(*case)}: vs plain |ddQ| {e_dq:.3g} |ddK| {e_dk:.3g} "
            f"|ddV| {e_dv:.3g} (tol {tol}), |dDelta| {e_dl:.3g} (tol "
            f"{TOL_LSE}); K1+K2+K3 vs autograd(mha_reference) |d| "
            f"{', '.join(f'{e:.3g}' for e, _ in mha)} (tol "
            f"{TOL_GRAD_MHA[dtype]}); K2 {k2_ms:.4f} ms (plain {k2_plain:.4f}, "
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
        if recs is None:
            recs = (dict(max_abs_err=max(e_dq, e_dl), ms=k2_ms,
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
        q, k, v, do = _case_inputs(gen, B, H, T, Dh, torch.bfloat16, False)
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

        # first generated token's logits: the engine's prefill path vs
        # forward's last position (T = 256: the flash kernel)
        with torch.inference_mode():
            ids = torch.tensor([a], device=device)
            fwd_last = gpt2.forward(eng.params, ids, eng.cfg)[0, -1].float()
            cache = gpt2.init_cache(eng.cfg, 4, window, device=device)
            C = eng.prefill_chunk_size
            for p0 in range(0, len(a), C):
                n = min(C, len(a) - p0)
                toks = torch.zeros((4, C), dtype=torch.long, device=device)
                toks[0, :n] = ids[0, p0:p0 + n]
                lanes = torch.tensor([n, 0, 0, 0], device=device)
                pos0 = torch.tensor([p0, 0, 0, 0], device=device)
                logits, cache = gpt2.prefill_chunk(
                    eng.params, cache, toks, pos0, lanes, lanes > 0, eng.cfg)
        first_err = float((logits[0] - fwd_last).abs().max())
        first_tok = int(logits[0].argmax())
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
    # cuBLAS names its kernels gemm/xmma/cutlass, or nvjet (CUDA 12.8+)
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
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


def _train_run(cfg, opt, batch, steps, profile_at) -> tuple:
    """`steps` steps from seeded params: ([(loss, grad_norm)], [step s],
    and the profile of step `profile_at`, as `_profiled` gives it)."""
    train = spmd.compile_gpt2_train(cfg, optimizer=opt, device=DEVICE)
    state = train.init_fn(torch.Generator().manual_seed(0))
    hist, secs, profile = [], [], None
    for i in range(steps):
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


def _log_profile(label, profile, profile_at, secs) -> None:
    """A profiled step's kernel time by group, set against the median
    unprofiled step: the profiled step's own wall time is no measure of
    idleness."""
    groups, top = profile
    busy = sum(groups.values())
    step_ms = _step_ms(secs, profile_at)
    log(f"[train {PRESET}] {label} step {profile_at + 1} under "
        f"torch.profiler (wall {secs[profile_at] * 1e3:.2f} ms with the "
        f"profiler): "
        + (f"kernels {busy:.2f} ms, {100 * busy / step_ms:.1f}% of the "
           f"median step ({step_ms:.2f} ms): "
           + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.most_common())
           + "; costliest: " + "; ".join(f"{ms:.2f} {name[:60]}"
                                         for ms, name in top)
           if busy else "the profiler saw no device time: not measured"))


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
    rate = {}
    for name, s, at in (("flash", secs, PROFILE_STEP),
                        ("dense", dsecs, dense_profile_at)):
        step_ms = _step_ms(s, at)
        rate[name] = (step_ms, B * T / step_ms * 1e3, 100 * fpt * B * T
                      / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16])
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


def main() -> int:
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
    k2, k3 = phase_backward(gen)
    phase_sweep(gen)

    # the inference main path: counts from 0, read right after
    _zero_counts()
    with torch.no_grad():
        phase_forward(torch.Generator().manual_seed(0))
    phase_serve(card)
    log(f"[inference path] K1/K2/K3 launches {_flash_counts()}")
    if fa.flash_attention.launches < 1:
        raise AssertionError("the inference path never launched K1")

    # the training main path (this slice's): phase_train zeroes the counts
    launches = phase_train(card)

    src = "ray_tpu/ops/flash_attention.py"
    kernels = [
        dict(name="flash_fwd (K1)", route="cuda",
             source="ray_tpu_torch/csrc/flash_fwd.cu", replaces=f"{src}:62",
             launches=launches[0], **k1),
        dict(name="flash_bwd_dq (K2)", route="cuda",
             source="ray_tpu_torch/csrc/flash_bwd.cu", replaces=f"{src}:141",
             launches=launches[1], **k2),
        dict(name="flash_bwd_dkv (K3)", route="cuda",
             source="ray_tpu_torch/csrc/flash_bwd.cu", replaces=f"{src}:175",
             launches=launches[2], **k3),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
