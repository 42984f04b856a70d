#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. build every CUDA kernel of the port from ray_tpu_torch/csrc with nvcc
   (sm_90a), and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and a few more, and time kernel, plain
   version and the library call that computes the same function;
3. GPT-2-125M forward and loss at full width (seeded random weights,
   B=4, T=1024) through the flash kernel, against the dense path;
4. the continuous-batching server at full width answering requests, with
   chunked prefill and a prefix-cache hit, greedy output equal with and
   without prefix reuse.
Phases 3 and 4 are the main path: every kernel's launch count is set to 0
before them and must be above 0 after. The line before the last lists the
kernels as JSON; the last line is {"ok": true, "device": {...}}. Any failure
raises and the script exits non-zero without that line. Needs one CUDA card;
imports nothing of JAX.

TF32 is off for matmuls and cuDNN (set below), so float32 products are full
float32 and the f32 comparisons are meaningful.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its operations over the
# peak for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs its plain version (the same online-softmax arithmetic in f32).
# f32: the reference kernel test's own tolerance. bf16: the two differ only
# where an f32 value rounds to the other side of a bf16 step, one ulp
# (2^-8 relative) of |O| <= ~4, so 1e-2 + 1e-2*|ref|; lse is f32 in both.
TOL_PLAIN = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
TOL_LSE = dict(atol=1e-4, rtol=1e-5)
# Kernel vs mha_reference: in bf16 the reference rounds the probabilities to
# bf16 before its product with V (2^-8 relative per weight) and multiplies in
# bf16, so the bound is wider.
TOL_MHA = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
# GPT-2-125M logits, bf16 activations through 12 layers, flash vs dense
# attention (and engine prefill vs forward): logits have std ~0.55 at this
# init; the two paths round at different places.
TOL_LOGITS = 0.1

# (name, B, H, T, Dh, dtype, causal); the first is the main path's shape
KERNEL_CASES = [
    ("main-path", 4, 12, 1024, 64, torch.bfloat16, True),
    ("b8-t1024", 8, 12, 1024, 64, torch.bfloat16, True),
    ("b2-t2048", 2, 12, 2048, 64, torch.bfloat16, True),
    ("non-causal", 4, 12, 1024, 64, torch.bfloat16, False),
    ("f32", 2, 12, 1024, 64, torch.float32, True),
    ("dh32", 2, 4, 256, 32, torch.bfloat16, True),
    ("dh128-f32", 2, 4, 256, 128, torch.float32, False),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def close(a, b, atol, rtol) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), bool((err <= atol + rtol * b.abs()).all())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events), after `warmup` calls. Inputs stay in L2 where they fit, as on
    the main path, where K1 reads q/k/v just written by the QKV product."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, H, Tq, Tk, Dh, dtype, causal) -> tuple:
    """(bound_ms, bound_by): the least time for the work the inputs need:
    each of q, k, v read once and O, lse written once; 4*Dh flops per
    (query, key) pair that the mask keeps."""
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    flops = 4.0 * B * H * Dh * pairs
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * B * H * Dh * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phases
def phase_build() -> None:
    t0 = time.perf_counter()
    info = _kernels.build_all()
    log(f"[build] {len(info)} kernel(s) built in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> dict:
    """K1 against flash_attention_reference and mha_reference; returns the
    main-path case's record."""
    main = None
    for name, B, H, T, Dh, dtype, causal in KERNEL_CASES:
        q, k, v = (torch.randn((B, H, T, Dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
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
        log(f"[K1 {name}] B={B} H={H} T={T} Dh={Dh} {str(dtype)[6:]} "
            f"causal={causal}: |dO| vs plain {err_o:.3g} "
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


def phase_forward(gen: torch.Generator, device="cuda", preset="gpt2-125m",
                  B=4, T=1024) -> None:
    cfg = gpt2.GPT2Config.preset(preset, attn_impl="flash")
    params = gpt2.init_params(gen, cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen
                           ).to(device)
    before = fa.flash_attention.launches
    logits = gpt2.forward(params, tokens[:, :T], cfg)
    if device == "cuda":
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


def phase_serve(card: str, device="cuda", preset="gpt2-125m",
                window=1024) -> None:
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = phase_kernels(gen)

    # the main path: counts from 0, read right after
    fa.flash_attention.launches = 0
    with torch.no_grad():
        phase_forward(torch.Generator().manual_seed(0))
    phase_serve(card)
    launches = fa.flash_attention.launches
    if launches < 1:
        raise AssertionError("the main path never launched K1")

    kernels = [dict(name="flash_fwd (K1)", route="cuda",
                    source="ray_tpu_torch/csrc/flash_fwd.cu",
                    replaces="ray_tpu/ops/flash_attention.py:62",
                    launches=launches, **k1)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
