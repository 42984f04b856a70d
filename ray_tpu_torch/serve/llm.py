"""LLM serving: the continuous-batching GPT-2 engine and its deployment
callable, in PyTorch (counterpart of `ray_tpu/serve/llm.py`).

A fixed batch of KV-cache slots runs `gpt2.decode_step` /
`gpt2.prefill_chunk` eagerly on the device; requests join free slots as
others finish (continuous batching), long prompts prefill in chunks under a
token budget, and prompts that share a prefix reuse pooled KV blocks
(`serve/kv_cache.py`). The engine runs on its own thread; a failed step fails
the requests it carried and the engine keeps serving.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class ByteTokenizer:
    """utf-8 bytes as token ids (1-256); eos = 0. Self-contained, so serving
    works without downloaded vocabularies."""

    eos_id = 0

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")][:2048]

    def decode(self, ids: List[int]) -> str:
        # ids beyond the byte range (larger model vocabs) wrap; this is a
        # demo tokenizer, not a real vocabulary
        return bytes((i - 1) % 256 for i in ids if i > 0).decode(
            "utf-8", errors="replace")


class _Request:
    def __init__(self, prompt_ids: List[int], max_tokens: int,
                 temperature: float, top_k: int = 0, top_p: float = 1.0):
        self.prompt_ids = prompt_ids
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.generated: List[int] = []
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.finish_reason: str = "stop"
        # streaming consumers: wakes on every appended token
        self.progress = threading.Condition()
        self._sent_text = ""  # cumulative text already shipped to the consumer
        self.t_enqueue = time.time()
        self.t_first: Optional[float] = None   # first generated token (TTFT)


def plan_chunk_budget(pending_lens: List[int], decoding: List[bool],
                      chunk_size: int, budget: int) -> List[int]:
    """Token-budget step plan for one continuous-batching tick: how many
    tokens each slot processes this step.

    Decode slots are reserved first and unconditionally (one token each),
    then the remaining budget is dealt to prefilling slots in slot order,
    capped at `chunk_size` per slot. When only prefills are live, at least
    one slot always makes progress regardless of budget.
    """
    n = len(pending_lens)
    takes = [0] * n
    for i in range(n):
        if decoding[i]:
            takes[i] = 1
            budget -= 1
    any_progress = any(takes)
    for i in range(n):
        if decoding[i] or pending_lens[i] <= 0:
            continue
        take = min(pending_lens[i], chunk_size, max(budget, 0))
        if take <= 0 and not any_progress:
            take = 1      # sole-prefill guarantee
        if take <= 0:
            continue
        takes[i] = take
        budget -= take
        any_progress = True
    return takes


class LLMEngine:
    """Continuous-batching decode engine over a fixed slot batch.

    `scheduler="continuous"` (default) is per-step join/evict with a
    token-budget step plan: new requests enter the running batch at the next
    step, finished sequences free their KV slot immediately, and long prompts
    prefill in `prefill_chunk_size`-token chunks under
    `max_num_batched_tokens` per step, decode lanes reserved first.
    `scheduler="fixed"` admits a batch only when every slot is free and runs
    it token by token to completion.

    Weights come from `checkpoint` (a `gpt2.save_params` directory, either
    package's), from `params_override` (+ `cfg_override`), or from `seed`.
    `device` defaults to CUDA and raises when there is none.
    """

    def __init__(self, preset: str = "gpt2-tiny", max_batch: int = 4,
                 max_seq_len: int = 128, seed: int = 0,
                 model_overrides: Optional[dict] = None,
                 checkpoint: Optional[str] = None,
                 tokenizer: Any = None,
                 enable_prefix_caching: bool = True,
                 kv_blocks: int = 64, kv_block_size: int = 16,
                 tensor_parallel_size: int = 1,
                 scheduler: str = "continuous",
                 prefill_chunk_size: int = 16,
                 max_num_batched_tokens: Optional[int] = None,
                 params_override=None, cfg_override=None,
                 device=None):
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.utils.platform import default_device

        if tensor_parallel_size != 1:
            raise NotImplementedError(
                "tensor_parallel_size > 1 needs the collective slice")
        if scheduler not in ("continuous", "fixed"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.gpt2 = gpt2
        self.device = default_device(device)
        overrides = dict(model_overrides or {})
        overrides.setdefault("max_seq_len", max_seq_len)
        if params_override is not None:
            self.cfg = (cfg_override if cfg_override is not None
                        else gpt2.GPT2Config.preset(preset, **overrides))
            self.params = params_override
        elif checkpoint:
            # architecture from the checkpoint sidecar, runtime knobs from
            # the preset/overrides
            base = gpt2.GPT2Config.preset(preset, **overrides)
            self.params, self.cfg = gpt2.load_params(checkpoint, cfg=base,
                                                     device=self.device)
        else:
            self.cfg = gpt2.GPT2Config.preset(preset, **overrides)
            gen = torch.Generator().manual_seed(seed)
            self.params = gpt2.init_params(gen, self.cfg, self.device)
        self.max_batch = max_batch
        # the caller's window caps KV-cache memory even when a checkpoint's
        # architecture allows a longer context
        self.max_seq_len = min(max_seq_len, self.cfg.max_seq_len)
        cfg = self.cfg
        self.cache = gpt2.init_cache(cfg, max_batch, self.max_seq_len,
                                     device=self.device)
        self.kv = None
        if enable_prefix_caching:
            from ray_tpu_torch.serve.kv_cache import PagedKVCache

            self.kv = PagedKVCache(cfg.n_layer, cfg.n_head, cfg.head_dim,
                                   num_blocks=kv_blocks,
                                   block_size=kv_block_size,
                                   dtype=cfg.dtype, device=self.device)
        self.scheduler = scheduler
        # chunk must fit the serving window (prefill_chunk requires C <= T)
        self.prefill_chunk_size = max(1, min(prefill_chunk_size,
                                             self.max_seq_len - 1))
        self.max_num_batched_tokens = (
            max_num_batched_tokens if max_num_batched_tokens
            else max(2 * max_batch, max_batch + self.prefill_chunk_size))
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._streams: Dict[str, tuple] = {}   # sid -> (request, last_access)
        self._slots: List[Optional[_Request]] = [None] * max_batch
        self._slot_pos = [0] * max_batch
        self._slot_prefill: List[List[int]] = [[] for _ in range(max_batch)]
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.total_generated = 0
        self.engine_steps = 0          # model step calls (either kind)
        self.chunk_steps = 0           # steps that ran prefill_chunk
        self.tokens_prefilled = 0      # prompt tokens processed
        self.step_errors = 0           # steps that raised
        self.ttft_sum = 0.0            # submit -> first generated token
        self.ttft_count = 0
        self.last_ttft_s = 0.0
        self._thread = threading.Thread(target=self._engine_loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------- public
    def generate(self, prompt: str = "", prompt_ids: Optional[List[int]] = None,
                 max_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 timeout: float = 120.0) -> Dict[str, Any]:
        req = self._make_request(prompt, prompt_ids, max_tokens,
                                 temperature, top_k, top_p)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return {"token_ids": req.generated,
                "text": self.tokenizer.decode(req.generated),
                "prompt_tokens": len(req.prompt_ids),
                "completion_tokens": len(req.generated)}

    def _make_request(self, prompt, prompt_ids, max_tokens, temperature,
                      top_k, top_p) -> _Request:
        ids = prompt_ids if prompt_ids is not None else \
            self.tokenizer.encode(prompt)
        ids = list(ids) or [self.tokenizer.eos_id]
        ids = ids[-(self.max_seq_len - 2):]
        budget = self.max_seq_len - len(ids) - 1
        return _Request(ids, max(0, min(max_tokens, budget)), temperature,
                        top_k=top_k, top_p=top_p)

    def start_stream(self, prompt: str = "",
                     prompt_ids: Optional[List[int]] = None,
                     max_tokens: int = 16, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0) -> str:
        """Admit a request for incremental consumption via stream_next."""
        req = self._make_request(prompt, prompt_ids, max_tokens,
                                 temperature, top_k, top_p)
        sid = uuid.uuid4().hex
        self._streams[sid] = (req, time.time())
        self._queue.put(req)
        return sid

    def stream_next(self, stream_id: str, cursor: int = 0,
                    timeout: float = 1.0) -> Dict[str, Any]:
        """Tokens generated beyond `cursor`, waiting at most `timeout`; an
        empty delta means "poll again". `text` is the delta of the cumulative
        decode (a multi-byte character is held back until complete). The
        stream entry is dropped once the consumer has read to the end."""
        ent = self._streams.get(stream_id)
        if ent is None:
            raise KeyError(f"unknown stream {stream_id}")
        req, _ = ent
        self._streams[stream_id] = (req, time.time())
        deadline = time.time() + timeout
        with req.progress:
            while (len(req.generated) <= cursor and not req.done.is_set()
                   and req.error is None):
                left = deadline - time.time()
                if left <= 0:
                    break
                req.progress.wait(left)
        if req.error:
            self._streams.pop(stream_id, None)
            return {"error": req.error, "done": True, "token_ids": [],
                    "text": "", "cursor": cursor}
        new = req.generated[cursor:]
        done = req.done.is_set() and cursor + len(new) >= len(req.generated)
        if done:
            self._streams.pop(stream_id, None)
        delta = ""
        if new or done:
            full = self.tokenizer.decode(req.generated[:cursor + len(new)])
            if not done and full.endswith("\ufffd"):
                full = full[:-1]
            delta = (full[len(req._sent_text):]
                     if full.startswith(req._sent_text) else full)
            req._sent_text = full
        return {"token_ids": new, "text": delta,
                "done": done, "cursor": cursor + len(new),
                "finish_reason": req.finish_reason if done else None}

    def shutdown(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    # ------------------------------------------------------------- engine
    def _admit(self):
        if self.scheduler == "fixed" and any(r is not None
                                             for r in self._slots):
            return     # a new batch forms only once every slot is free
        for i in range(self.max_batch):
            if self._slots[i] is None:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                self._place(i, req)

    def _place(self, i: int, req: _Request) -> None:
        self._slots[i] = req
        self._slot_pos[i] = 0
        self._slot_prefill[i] = list(req.prompt_ids)
        if self.kv is not None and len(req.prompt_ids) > 1:
            # the last prompt token is always re-run (its logits seed
            # generation), so match against ids[:-1]
            n_hit, blocks = self.kv.match_prefix(req.prompt_ids[:-1])
            if n_hit:
                self.kv.copy_into_slot(self.cache, i, blocks)
                self._slot_pos[i] = n_hit
                self._slot_prefill[i] = list(req.prompt_ids[n_hit:])

    def _sweep_streams(self) -> None:
        """Expire abandoned stream entries (client vanished)."""
        now = time.time()
        for sid, (r, ts) in list(self._streams.items()):
            if r.done.is_set() and now - ts > 300:
                self._streams.pop(sid, None)

    def _engine_loop(self):
        rng = np.random.default_rng(0)
        last_sweep = time.time()
        with torch.inference_mode():
            while not self._stop.is_set():
                if time.time() - last_sweep > 60:
                    last_sweep = time.time()
                    self._sweep_streams()
                self._admit()
                live = [i for i, r in enumerate(self._slots) if r is not None]
                if not live:
                    time.sleep(0.005)
                    continue
                try:
                    if any(self._slot_prefill[i] for i in live) \
                            and self.scheduler == "continuous":
                        self._run_chunk_step(live, rng)
                    else:
                        self._run_decode_step(live, rng)
                except Exception:  # the engine thread must keep serving
                    self._fail_live(live, traceback.format_exc())

    def _fail_live(self, live, err: str) -> None:
        """A step raised: fail the requests it carried and free their slots.
        Their cache lanes are rewritten from position 0 by the next
        request placed there."""
        self.step_errors += 1
        for i in live:
            req = self._slots[i]
            if req is None:
                continue
            self._slots[i] = None
            req.error = f"engine step failed:\n{err}"
            req.done.set()
            with req.progress:
                req.progress.notify_all()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_decode_step(self, live, rng):
        """One single-token step for every live slot (the pure-decode path;
        the only step the fixed scheduler runs)."""
        tokens = np.zeros((self.max_batch,), np.int64)
        pos = np.asarray(self._slot_pos, np.int64)
        active = np.zeros((self.max_batch,), bool)
        for i in live:
            active[i] = True
            if self._slot_prefill[i]:
                tokens[i] = self._slot_prefill[i][0]
            else:
                tokens[i] = (self._slots[i].generated[-1]
                             if self._slots[i].generated
                             else self._slots[i].prompt_ids[-1])
        logits, self.cache = self.gpt2.decode_step(
            self.params, self.cache, self._tensor(tokens), self._tensor(pos),
            self._tensor(active), self.cfg)
        logits = logits.cpu().numpy()
        self.engine_steps += 1
        for i in live:
            req = self._slots[i]
            self._slot_pos[i] += 1
            if self._slot_prefill[i]:
                self._slot_prefill[i].pop(0)
                self.tokens_prefilled += 1
                if self._slot_prefill[i]:
                    continue  # still prefilling; ignore logits
                if self.kv is not None:
                    # prompt fully resident: publish its full blocks
                    self.kv.store_prefix(req.prompt_ids, self.cache, i)
            self._finish_token(i, req, logits[i], rng)

    def _run_chunk_step(self, live, rng):
        """One token-budget step: decode slots advance one token each
        (reserved first), prefilling slots consume up to a chunk of their
        remaining prompt, all in one prefill_chunk call."""
        B, C = self.max_batch, self.prefill_chunk_size
        pending = [len(self._slot_prefill[i]) if self._slots[i] is not None
                   else 0 for i in range(B)]
        decoding = [self._slots[i] is not None and not self._slot_prefill[i]
                    for i in range(B)]
        takes = plan_chunk_budget(pending, decoding, C,
                                  self.max_num_batched_tokens)
        tokens = np.zeros((B, C), np.int64)
        lengths = np.zeros((B,), np.int64)
        for i in live:
            # never step past the serving window
            take = min(takes[i], self.max_seq_len - self._slot_pos[i])
            if take <= 0:
                continue
            lengths[i] = take
            if self._slot_prefill[i]:
                tokens[i, :take] = self._slot_prefill[i][:take]
            else:
                req = self._slots[i]
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt_ids[-1])
        active = lengths > 0
        if not active.any():
            time.sleep(0.001)
            return
        logits, self.cache = self.gpt2.prefill_chunk(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(np.asarray(self._slot_pos, np.int64)),
            self._tensor(lengths), self._tensor(active), self.cfg)
        logits = logits.cpu().numpy()
        self.engine_steps += 1
        self.chunk_steps += 1
        for i in live:
            take = int(lengths[i])
            if take <= 0:
                continue
            req = self._slots[i]
            self._slot_pos[i] += take
            if self._slot_prefill[i]:
                del self._slot_prefill[i][:take]
                self.tokens_prefilled += take
                if self._slot_prefill[i]:
                    continue  # chunk didn't cover the prompt yet
                if self.kv is not None:
                    self.kv.store_prefix(req.prompt_ids, self.cache, i)
            self._finish_token(i, req, logits[i], rng)

    def _finish_token(self, i, req, logit_row, rng):
        """Sample one token from `logit_row`, append it, and evict the slot
        the moment the request finishes."""
        if req.temperature > 0:
            lg = logit_row / req.temperature
            if req.top_k and req.top_k < len(lg):
                kth = np.partition(lg, -req.top_k)[-req.top_k]
                lg = np.where(lg < kth, -np.inf, lg)
            p = np.exp(lg - lg.max())
            p /= p.sum()
            if req.top_p < 1.0:
                # nucleus: keep a token while the mass before it is still
                # short of top_p
                order = np.argsort(p)[::-1]
                csum = np.cumsum(p[order])
                keep = (csum - p[order]) < req.top_p
                mask = np.zeros_like(p, bool)
                mask[order[keep]] = True
                p = np.where(mask, p, 0.0)
                p /= p.sum()
            nxt = int(rng.choice(len(p), p=p))
        else:
            nxt = int(np.argmax(logit_row))
        if req.t_first is None:
            req.t_first = time.time()
            with self._stats_lock:
                self.last_ttft_s = req.t_first - req.t_enqueue
                self.ttft_sum += self.last_ttft_s
                self.ttft_count += 1
        req.generated.append(nxt)
        self.total_generated += 1
        finished = (len(req.generated) >= req.max_tokens
                    or nxt == self.tokenizer.eos_id
                    or self._slot_pos[i] >= self.max_seq_len - 1)
        if finished:
            req.finish_reason = ("stop" if nxt == self.tokenizer.eos_id
                                 else "length")
            self._slots[i] = None
            req.done.set()
        with req.progress:
            req.progress.notify_all()

    def engine_stats(self) -> dict:
        with self._stats_lock:
            ttft_avg = (self.ttft_sum / self.ttft_count
                        if self.ttft_count else 0.0)
            last_ttft = self.last_ttft_s
        return {"scheduler": self.scheduler,
                "max_batch": self.max_batch,
                "prefill_chunk_size": self.prefill_chunk_size,
                "max_num_batched_tokens": self.max_num_batched_tokens,
                "total_generated": self.total_generated,
                "engine_steps": self.engine_steps,
                "chunk_steps": self.chunk_steps,
                "tokens_prefilled": self.tokens_prefilled,
                "step_errors": self.step_errors,
                "queued": self._queue.qsize(),
                "slots_busy": sum(r is not None for r in self._slots),
                "ttft_avg_s": ttft_avg,
                "last_ttft_s": last_ttft}


class LLMServer:
    """Deployment callable: OpenAI-completions-shaped request handling."""

    def __init__(self, preset: str = "gpt2-tiny", max_batch: int = 4,
                 max_seq_len: int = 128, model_overrides: Optional[dict] = None,
                 checkpoint: Optional[str] = None, tokenizer: Any = None,
                 **engine_kwargs):
        self.engine = LLMEngine(preset=preset, max_batch=max_batch,
                                max_seq_len=max_seq_len,
                                model_overrides=model_overrides,
                                checkpoint=checkpoint, tokenizer=tokenizer,
                                **engine_kwargs)
        # distinguishes replicas when a caller aggregates stats() rows
        self.server_id = uuid.uuid4().hex[:12]

    def __call__(self, request: Any) -> dict:
        body = request if isinstance(request, dict) else getattr(
            request, "json", None) or {}
        eng = self.engine
        ids = body.get("prompt_ids")
        if ids is None:
            ids = eng.tokenizer.encode(body.get("prompt", ""))
        out = eng.generate(
            prompt_ids=list(ids) or [eng.tokenizer.eos_id],
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)))
        return {
            "object": "text_completion",
            "choices": [{"text": out["text"], "index": 0,
                         "token_ids": out["token_ids"],
                         "finish_reason": "length"}],
            "usage": {"completion_tokens": len(out["token_ids"])},
        }

    def stats(self) -> dict:
        out = self.engine.engine_stats()
        out["server_id"] = self.server_id
        if self.engine.kv is not None:
            out["kv_cache"] = self.engine.kv.stats()
        return out

    def check_health(self):
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine loop died")

    def shutdown(self):
        self.engine.shutdown()
