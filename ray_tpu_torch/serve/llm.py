"""LLM serving: the continuous-batching GPT-2 engine and its deployment
callable, in PyTorch (counterpart of `ray_tpu/serve/llm.py`).

A fixed batch of KV-cache slots runs `gpt2.decode_step` /
`gpt2.prefill_chunk` eagerly on the device; requests join free slots as
others finish (continuous batching), long prompts prefill in chunks under a
token budget, and prompts that share a prefix reuse pooled KV blocks
(`serve/kv_cache.py`). The engine runs on its own thread; a failed step fails
the requests it carried and the engine keeps serving. A prefill engine's
pooled KV blocks export as host blobs that a decode engine imports, and a
request can wait for such a blob (a prefix future) while other lanes decode.

`LLMServer` is the deployment callable (`batch_call` admits a batch of
requests at once so they share steps); `OpenAIServer` serves /v1/models,
/v1/completions and /v1/chat/completions, streaming included, with LoRA
adapters merged into per-adapter engines under an LRU.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
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


class HFTokenizer:
    """transformers tokenizer adapter for the served checkpoint's vocabulary.
    The vocabulary must already be on disk: construction never downloads
    (`local_files_only=True`) and fails instead."""

    def __init__(self, name_or_path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError("HFTokenizer requires `transformers`") from e
        self._tok = AutoTokenizer.from_pretrained(name_or_path,
                                                  local_files_only=True)
        self.eos_id = self._tok.eos_token_id or 0

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)


class _Request:
    def __init__(self, prompt_ids: List[int], max_tokens: int,
                 temperature: float, top_k: int = 0, top_p: float = 1.0,
                 prefix_future=None, prefix_wait_s: float = 30.0):
        self.prompt_ids = prompt_ids
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        # a concurrent.futures.Future resolving to a KV blob (or None): the
        # engine parks this request until the blob lands, other lanes keep
        # decoding, and prefills locally at the deadline
        self.prefix_future = prefix_future
        self.prefix_deadline = time.time() + prefix_wait_s
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


def _tp_devices(device, tp: int) -> list:
    """The devices of a `tp`-way engine: `device` for every shard (one
    device given), the list given (of tp), or the first tp CUDA devices."""
    from ray_tpu_torch.utils.platform import default_device

    if tp < 1:
        raise ValueError(f"tensor_parallel_size={tp} must be >= 1")
    if isinstance(device, (list, tuple)):
        if len(device) != tp:
            raise ValueError(f"tensor_parallel_size={tp} needs {tp} "
                             f"devices, got {len(device)}")
        return [default_device(d) for d in device]
    if device is not None or tp == 1:
        return [default_device(device)] * tp
    default_device(None)             # raises without CUDA
    if torch.cuda.device_count() < tp:
        raise ValueError(f"tensor_parallel_size={tp} needs {tp} CUDA "
                         f"devices, {torch.cuda.device_count()} exist")
    return [torch.device("cuda", i) for i in range(tp)]


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
    With `weight_store=True` (the default) a checkpoint is first looked up
    on the cluster's weight plane (`serve/weight_store.py`: resolved from
    the gossiped directory with zero head RPCs, streamed from peer
    replicas), and an engine that paid the checkpoint read publishes its
    params back; outside a runtime, or on any miss, the checkpoint is read.
    `weights_source` says which ("p2p", "checkpoint", "override", "seed").
    `weights_id` names the weights for prefix-store keys
    (`prefix_model_key`).
    `device` defaults to CUDA and raises when there is none.

    `tensor_parallel_size=N > 1` is the JAX package's single-controller tp
    engine: this process drives N devices (`device`: one device for every
    shard, or a list of N; by default the first N CUDA devices, raising
    when fewer exist). The params are cut into a shard a device
    (`gpt2.tp_shards`: heads and d_ff columns; the tied embedding whole)
    and each device's KV cache and prefix pool hold its heads; the
    row-parallel products' partial sums meet in a
    `LocalCollectiveGroup.allreduce`, which folds in device order so every
    device holds the same bits. The scheduler, sampling, streams and
    statistics run once, on the host; `self.params` stays the whole tree
    on the first device (LoRA merges read it). tp must divide n_head and
    d_ff.
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
                 weights_id: Optional[str] = None, device=None,
                 weight_store: bool = True):
        from ray_tpu_torch.models import gpt2

        if scheduler not in ("continuous", "fixed"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.gpt2 = gpt2
        self.tp = tensor_parallel_size
        self.devices = _tp_devices(device, self.tp)
        self.device = self.devices[0]
        overrides = dict(model_overrides or {})
        overrides.setdefault("max_seq_len", max_seq_len)
        if params_override is not None:
            self.cfg = (cfg_override if cfg_override is not None
                        else gpt2.GPT2Config.preset(preset, **overrides))
            self.params = params_override
            self.weights_source = "override"
        elif checkpoint:
            # architecture from the checkpoint sidecar, runtime knobs from
            # the preset/overrides. Cold start tries the weight plane
            # first and degrades to the checkpoint-path read on any miss;
            # the engine that pays the path read publishes the tree back,
            # so the NEXT replica of this model pulls from peers
            base = gpt2.GPT2Config.preset(preset, **overrides)
            self.params = None
            t0 = time.perf_counter()
            if weight_store:
                from ray_tpu_torch.serve import weight_store as _ws

                try:
                    store = _ws.get_store()
                    loaded = (store.load_params(checkpoint, base_cfg=base,
                                                device=self.device)
                              if store is not None else None)
                except Exception:
                    loaded = None   # never fail init on the store
                if loaded is not None:
                    self.params, self.cfg = loaded
                    self.weights_source = "p2p"
            if self.params is None:
                self.params, self.cfg = gpt2.load_params(
                    checkpoint, cfg=base, device=self.device)
                self.weights_source = "checkpoint"
            self.cold_start_s = time.perf_counter() - t0
            if weight_store:
                _ws.observe_cold_start(self.cold_start_s,
                                       self.weights_source)
                if self.weights_source == "checkpoint":
                    _ws.maybe_publish_params_async(
                        self.params, checkpoint,
                        arch={k: getattr(self.cfg, k)
                              for k in gpt2._CFG_FIELDS})
        else:
            self.cfg = gpt2.GPT2Config.preset(preset, **overrides)
            gen = torch.Generator().manual_seed(seed)
            self.params = gpt2.init_params(gen, self.cfg, self.device)
            self.weights_source = "seed"
        # weight identity for prefix-store keys: engines whose KV is
        # interchangeable agree on it. LoRA engines pass the base's id; an
        # override without one gets a unique id, which never collides
        if weights_id is not None:
            self.weights_id = weights_id
        elif params_override is not None:
            self.weights_id = f"override-{uuid.uuid4().hex[:12]}"
        else:
            self.weights_id = checkpoint or f"{preset}@seed{seed}"
        self.max_batch = max_batch
        # the caller's window caps KV-cache memory even when a checkpoint's
        # architecture allows a longer context
        self.max_seq_len = min(max_seq_len, self.cfg.max_seq_len)
        cfg = self.cfg
        if self.tp == 1:
            self.cache = gpt2.init_cache(cfg, max_batch, self.max_seq_len,
                                         device=self.device)
        else:
            from ray_tpu_torch.util.collective.local_group import \
                LocalCollectiveGroup

            self.shards = gpt2.tp_shards(self.params, cfg, self.devices)
            self.group = LocalCollectiveGroup(self.devices)
            self.cache = gpt2.tp_init_caches(cfg, max_batch,
                                             self.max_seq_len, self.devices)
        self.kv = None
        if enable_prefix_caching:
            from ray_tpu_torch.serve.kv_cache import PagedKVCache

            self.kv = PagedKVCache(cfg.n_layer, cfg.n_head, cfg.head_dim,
                                   num_blocks=kv_blocks,
                                   block_size=kv_block_size,
                                   dtype=cfg.dtype, devices=self.devices)
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
        # requests whose prefix blob is still in flight park here while
        # other lanes decode; resolved ones re-enter admission first
        self._deferred: List[_Request] = []
        self._ready: List[_Request] = []
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.total_generated = 0
        self.engine_steps = 0          # model step calls (either kind)
        self.chunk_steps = 0           # steps that ran prefill_chunk
        self.tokens_prefilled = 0      # prompt tokens processed
        self.step_errors = 0           # steps that raised
        self.prefix_imports = 0        # deferred blobs installed
        self.prefix_blocks_imported = 0
        self.prefix_wait_timeouts = 0  # deadline hit: local prefill
        self.ttft_sum = 0.0            # submit -> first generated token
        self.ttft_count = 0
        self.last_ttft_s = 0.0
        # callables that must run on the engine thread, between steps: the
        # KV pool is engine-owned, unlocked state
        self._engine_calls: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._engine_loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------- public
    @property
    def prefix_model_key(self) -> Optional[str]:
        """Prefix-store key: engines with interchangeable KV (same weights
        and cache geometry) agree, anything else differs. The same string
        as the JAX package's engine gives."""
        if self.kv is None:
            return None
        from ray_tpu_torch.serve.prefix_store import model_cache_key

        cfg = self.cfg
        return model_cache_key(self.weights_id, cfg.n_layer, cfg.n_head,
                               cfg.head_dim,
                               str(cfg.dtype).removeprefix("torch."),
                               self.kv.block_size)

    def generate(self, prompt: str = "", prompt_ids: Optional[List[int]] = None,
                 max_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 timeout: float = 120.0, prefix_future=None,
                 prefix_wait_s: float = 30.0) -> Dict[str, Any]:
        req = self._make_request(prompt, prompt_ids, max_tokens,
                                 temperature, top_k, top_p,
                                 prefix_future, prefix_wait_s)
        self._submit(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return {"token_ids": req.generated,
                "text": self.tokenizer.decode(req.generated),
                "prompt_tokens": len(req.prompt_ids),
                "completion_tokens": len(req.generated)}

    def _make_request(self, prompt, prompt_ids, max_tokens, temperature,
                      top_k, top_p, prefix_future=None,
                      prefix_wait_s: float = 30.0) -> _Request:
        ids = prompt_ids if prompt_ids is not None else \
            self.tokenizer.encode(prompt)
        ids = list(ids) or [self.tokenizer.eos_id]
        ids = ids[-(self.max_seq_len - 2):]
        budget = self.max_seq_len - len(ids) - 1
        return _Request(ids, max(0, min(max_tokens, budget)), temperature,
                        top_k=top_k, top_p=top_p, prefix_future=prefix_future,
                        prefix_wait_s=prefix_wait_s)

    def _submit(self, req: _Request) -> None:
        if self._stop.is_set():
            raise RuntimeError("engine shut down")
        self._queue.put(req)

    def start_stream(self, prompt: str = "",
                     prompt_ids: Optional[List[int]] = None,
                     max_tokens: int = 16, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0,
                     prefix_future=None, prefix_wait_s: float = 30.0) -> str:
        """Admit a request for incremental consumption via stream_next (the
        engine path behind OpenAI `stream: true`)."""
        req = self._make_request(prompt, prompt_ids, max_tokens,
                                 temperature, top_k, top_p,
                                 prefix_future, prefix_wait_s)
        sid = uuid.uuid4().hex
        self._streams[sid] = (req, time.time())
        self._submit(req)
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

    # --------------------------------------------- KV transfer (prefill/decode)
    def export_prefix(self, prompt: str = "",
                      prompt_ids: Optional[List[int]] = None):
        """Prefill side of disaggregated serving: run (or reuse) the prompt's
        prefill, then hand back a host blob of its pooled KV blocks for a
        decode engine to import (`kv_cache.export_prefix`'s schema)."""
        if self.kv is None:
            raise RuntimeError("prefix caching disabled: no KV to export")
        ids = prompt_ids if prompt_ids is not None else \
            self.tokenizer.encode(prompt)
        ids = list(ids)[-(self.max_seq_len - 2):]
        blob = self.export_pooled(ids[:-1])
        if blob is None or len(blob["ids"]) < len(ids) - 1 - \
                (len(ids) - 1) % self.kv.block_size:
            # not pooled yet: a one-token generation prefills the prompt and
            # pools its blocks
            self.generate(prompt_ids=ids, max_tokens=1)
            blob = self.export_pooled(ids[:-1])
        return blob

    def export_pooled(self, ids: List[int], timeout: float = 30.0):
        """Export `ids`' pooled KV blocks, on the engine thread: an export
        racing a block's eviction and reuse could copy another request's
        bytes under this prompt's hash."""
        from ray_tpu_torch.serve.kv_cache import export_prefix as _export

        ids = list(ids)
        return self._on_engine(lambda: _export(self.kv, ids), timeout)

    def import_prefix(self, blob, timeout: float = 30.0) -> int:
        """Decode side: install exported KV blocks (on the engine thread);
        later prompts that share the prefix skip its prefill. Returns the
        number of new blocks installed."""
        if self.kv is None:
            raise RuntimeError("prefix caching disabled: no KV to import")
        from ray_tpu_torch.serve.kv_cache import import_prefix as _import

        return self._on_engine(lambda: _import(self.kv, blob), timeout)

    def _on_engine(self, fn, timeout: float):
        """fn() run on the engine thread between steps, its result or its
        exception handed back. Runs fn here when called from the engine
        thread or once the engine has stopped, and also when the engine has
        not taken the call within `timeout` (a wedged engine)."""
        if (threading.current_thread() is self._thread
                or not self._thread.is_alive()):
            return fn()
        fut: Future = Future()

        def call():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(fn())
            except BaseException as e:   # handed to the caller
                fut.set_exception(e)

        self._engine_calls.put(call)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeout:
            if fut.cancel():
                return fn()
            return fut.result(timeout=timeout)

    def shutdown(self, timeout: float = 10.0):
        """Stop the engine thread and join it (unless called from it). The
        requests it still held fail with "engine shut down"."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    # ------------------------------------------------------------- engine
    def _admit(self):
        self._admit_deferred()
        if self.scheduler == "fixed" and any(r is not None
                                             for r in self._slots):
            return     # a new batch forms only once every slot is free
        for i in range(self.max_batch):
            if self._slots[i] is None:
                req = self._next_ready()
                if req is None:
                    return
                self._place(i, req)

    def _next_ready(self) -> Optional[_Request]:
        """Next admittable request: resolved deferred requests first, then
        the queue. A queued request whose prefix blob is still in flight
        parks in `_deferred` and its slot goes to the next request."""
        while True:
            if self._ready:
                return self._ready.pop(0)
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return None
            fut = req.prefix_future
            if fut is not None and not fut.done() \
                    and time.time() < req.prefix_deadline:
                self._deferred.append(req)
                continue
            self._resolve_prefix(req)
            return req

    def _admit_deferred(self) -> None:
        """Move parked requests whose blob landed (imported here, on the
        engine thread) or whose deadline passed (local prefill) to
        `_ready`."""
        if not self._deferred:
            return
        now = time.time()
        still: List[_Request] = []
        for req in self._deferred:
            fut = req.prefix_future
            if fut is not None and not fut.done() \
                    and now < req.prefix_deadline:
                still.append(req)
                continue
            self._resolve_prefix(req)
            self._ready.append(req)
        self._deferred = still

    def _resolve_prefix(self, req: _Request) -> None:
        fut, req.prefix_future = req.prefix_future, None
        if fut is None:
            return
        blob = None
        if fut.done():
            try:
                blob = fut.result()
            except Exception:
                blob = None   # a failed fetch: local prefill
        else:
            fut.cancel()      # deadline passed: prefill locally instead
            self.prefix_wait_timeouts += 1
        if blob and self.kv is not None:
            try:
                installed = self.import_prefix(blob)
            except Exception:  # a bad blob: local prefill is always correct
                return
            self.prefix_imports += 1
            self.prefix_blocks_imported += installed

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
                self._run_engine_calls()
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
                    self.step_errors += 1
                    self._fail_live(live, "engine step failed:\n"
                                    + traceback.format_exc())
            # stopped: no request waits on a thread that is gone
            self._run_engine_calls()
            self._fail_live(range(self.max_batch), "engine shut down")
            waiting = self._deferred + self._ready
            self._deferred, self._ready = [], []
            while True:
                try:
                    waiting.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for req in waiting:
                self._fail(req, "engine shut down")

    def _run_engine_calls(self) -> None:
        """Run the calls other threads queued for this thread (each hands
        its own result or exception back through its future)."""
        while True:
            try:
                call = self._engine_calls.get_nowait()
            except queue.Empty:
                return
            call()

    @staticmethod
    def _fail(req: _Request, err: str) -> None:
        req.error = err
        req.done.set()
        with req.progress:
            req.progress.notify_all()

    def _fail_live(self, live, err: str) -> None:
        """Fail the requests in the `live` slots and free the slots. Their
        cache lanes are rewritten from position 0 by the next request placed
        there."""
        for i in live:
            req = self._slots[i]
            if req is None:
                continue
            self._slots[i] = None
            self._fail(req, err)

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
        args = (self._tensor(tokens), self._tensor(pos),
                self._tensor(active), self.cfg)
        if self.tp == 1:
            logits, self.cache = self.gpt2.decode_step(
                self.params, self.cache, *args)
        else:
            logits, self.cache = self.gpt2.tp_decode_step(
                self.shards, self.cache, *args, self.group.allreduce)
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
        args = (self._tensor(tokens),
                self._tensor(np.asarray(self._slot_pos, np.int64)),
                self._tensor(lengths), self._tensor(active), self.cfg)
        if self.tp == 1:
            logits, self.cache = self.gpt2.prefill_chunk(
                self.params, self.cache, *args)
        else:
            logits, self.cache = self.gpt2.tp_prefill_chunk(
                self.shards, self.cache, *args, self.group.allreduce)
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
                "weights_source": self.weights_source,
                "max_batch": self.max_batch,
                "prefill_chunk_size": self.prefill_chunk_size,
                "max_num_batched_tokens": self.max_num_batched_tokens,
                "total_generated": self.total_generated,
                "engine_steps": self.engine_steps,
                "chunk_steps": self.chunk_steps,
                "tokens_prefilled": self.tokens_prefilled,
                "step_errors": self.step_errors,
                "prefix_imports": self.prefix_imports,
                "prefix_blocks_imported": self.prefix_blocks_imported,
                "prefix_wait_timeouts": self.prefix_wait_timeouts,
                "queued": self._queue.qsize(),
                "deferred": len(self._deferred),
                "slots_busy": sum(r is not None for r in self._slots),
                "ttft_avg_s": ttft_avg,
                "last_ttft_s": last_ttft}


class LLMServer:
    """Deployment callable: OpenAI-completions-shaped request handling.

    `cluster_prefix_cache=True` joins the cluster prefix tier
    (`serve/prefix_store.py`, keyed by the engine's `prefix_model_key`): a
    request whose prompt another replica already prefilled warm-starts
    from that replica's published KV blob, fetched in the background while
    other lanes decode, and every completed prompt is published in turn.
    Outside a runtime the store does nothing."""

    def __init__(self, preset: str = "gpt2-tiny", max_batch: int = 4,
                 max_seq_len: int = 128, model_overrides: Optional[dict] = None,
                 checkpoint: Optional[str] = None, tokenizer: Any = None,
                 cluster_prefix_cache: bool = False,
                 **engine_kwargs):
        self.engine = LLMEngine(preset=preset, max_batch=max_batch,
                                max_seq_len=max_seq_len,
                                model_overrides=model_overrides,
                                checkpoint=checkpoint, tokenizer=tokenizer,
                                **engine_kwargs)
        # cluster prefix tier: any replica warm-starts from prefixes
        # computed anywhere in the cluster
        self.prefix_store = None
        if cluster_prefix_cache and self.engine.kv is not None:
            from ray_tpu_torch.serve import prefix_store as _ps

            self.prefix_store = _ps.store_for_engine(self.engine)
        self._prefix_pool = None
        self._prefix_pool_lock = threading.Lock()
        self._chain_pool = None
        self._chain_pool_lock = threading.Lock()
        # distinguishes replicas when a caller aggregates stats() rows
        self.server_id = uuid.uuid4().hex[:12]

    # ------------------------------------------------- cluster prefix tier
    def _prefix_submit(self, fn, *args):
        with self._prefix_pool_lock:
            if self._prefix_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._prefix_pool = ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="prefix-fetch")
        return self._prefix_pool.submit(fn, *args)

    def _warm_start_future(self, eng: LLMEngine, ids: List[int],
                           tenant: str = "base"):
        """Residency-tier fall-through for one prompt: the engine's own
        pool (no fetch wins below a block of gain) -> cluster store lookup
        (zero RPCs, cached directory) -> a background data-plane fetch
        whose future the engine imports while other lanes decode. Returns
        the blob future, or None when nothing beats the local pool."""
        store = self.prefix_store
        if store is None or eng.kv is None or len(ids) < 2:
            return None
        need = ids[:-1]
        covered = eng.kv.peek_prefix_len(need)
        if len(need) - covered < eng.kv.block_size:
            return None
        hit = store.lookup(need, tenant=tenant)
        if hit is None or hit["n"] <= covered:
            return None
        return self._prefix_submit(store.fetch, hit, tenant)

    def _publish_prefix(self, eng: LLMEngine, ids: List[int]) -> None:
        """After a completed generation the prompt's blocks are pooled:
        announce them so any OTHER replica can warm-start (shared prefixes
        are stored once cluster-wide). Runs on the prefix executor: the
        export's device-to-host copy, seal and announce are not charged to
        the response."""
        store = self.prefix_store
        if store is None or eng.kv is None or len(ids) < 2:
            return
        self._prefix_submit(self._publish_prefix_sync, store, eng, ids)

    @staticmethod
    def _publish_prefix_sync(store, eng: LLMEngine, ids: List[int]) -> None:
        try:
            store.maybe_publish(eng.kv, ids[:-1], exporter=eng.export_pooled)
        except Exception:
            pass   # publication is an optimization, never a failure path

    def _request_ids(self, eng: LLMEngine, body: dict,
                     prompt: str = "") -> List[int]:
        ids = body.get("prompt_ids")
        if ids is None:
            ids = eng.tokenizer.encode(prompt or body.get("prompt", ""))
        ids = list(ids) or [eng.tokenizer.eos_id]
        return ids[-(eng.max_seq_len - 2):]

    def __call__(self, request: Any) -> dict:
        body = request if isinstance(request, dict) else getattr(
            request, "json", None) or {}
        ids = self._request_ids(self.engine, body)
        out = self.engine.generate(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            prefix_future=self._warm_start_future(self.engine, ids))
        self._publish_prefix(self.engine, ids)
        return {
            "object": "text_completion",
            "choices": [{"text": out["text"], "index": 0,
                         "token_ids": out["token_ids"],
                         "finish_reason": "length"}],
            "usage": {"completion_tokens": len(out["token_ids"])},
        }

    def batch_call(self, requests: list) -> list:
        """Compiled-chain batch entry: every request is admitted at once
        (a pool of max(8, max_batch) threads), so the scheduler joins them
        into shared steps. Answers come back in order; an item that fails
        gives {CHAIN_ERR: repr(error), "infra": False} and does not fail
        its neighbours."""
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.serve.compiled_chain import CHAIN_ERR

        with self._chain_pool_lock:
            if self._chain_pool is None:
                self._chain_pool = ThreadPoolExecutor(
                    max_workers=max(8, self.engine.max_batch),
                    thread_name_prefix="chain-batch")
        futs = [self._chain_pool.submit(self, r) for r in requests]
        out = []
        for f in futs:
            try:
                out.append(f.result())
            except Exception as e:   # a user error stays with its item
                out.append({CHAIN_ERR: repr(e), "infra": False})
        return out

    def stream_next(self, stream_id: str, cursor: int = 0) -> dict:
        """Incremental tokens for an SSE stream (proxy-driven pull)."""
        return self.engine.stream_next(stream_id, cursor=cursor)

    def stats(self) -> dict:
        out = self.engine.engine_stats()
        out["server_id"] = self.server_id
        if self.engine.kv is not None:
            out["kv_cache"] = self.engine.kv.stats()
        if self.prefix_store is not None:
            out["prefix_store"] = self.prefix_store.stats()
        return out

    def check_health(self):
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine loop died")

    def shutdown(self):
        self.engine.shutdown()
        for pool in (self._chain_pool, self._prefix_pool):
            if pool is not None:
                pool.shutdown(wait=True)


class OpenAIServer(LLMServer):
    """OpenAI-compatible API: /v1/models, /v1/completions and
    /v1/chat/completions (mount with route_prefix="/v1").

    LoRA multiplexing: a request's `model` "<base>:<adapter>" resolves to
    `{lora_root}/{adapter}.npz`, merged into the base params
    (`gpt2.apply_lora`) and served by its own engine on the base engine's
    device, with the base's resolved config and weights_id; at most
    `max_loras` adapter engines stay loaded, least recently used evicted
    and shut down first. `stream: true` returns a stream marker that
    `stream_next` polls."""

    def __init__(self, model_id: str = "ray-tpu-llm",
                 lora_root: Optional[str] = None, max_loras: int = 2,
                 **kwargs):
        super().__init__(**kwargs)
        self.model_id = model_id
        self.lora_root = lora_root
        self.max_loras = max_loras
        self._lora_engines: "OrderedDict[str, LLMEngine]" = OrderedDict()
        # held while an adapter engine is looked up or built: two requests
        # for a new adapter build one engine. No engine loop takes it
        self._lora_lock = threading.Lock()
        self._engine_kwargs = dict(kwargs)
        # sid -> (engine, prompt_ids): where stream_next finds the stream
        self._stream_owner: Dict[str, tuple] = {}

    def loaded_lora_ids(self):
        return list(self._lora_engines)

    def _tenant_of(self, body: dict) -> str:
        """Adapter id of the request (`model="<base>:<adapter>"`), or
        "base"."""
        model = (body or {}).get("model")
        if model and ":" in str(model):
            return str(model).rsplit(":", 1)[1]
        return "base"

    def _engine_for(self, body: dict) -> LLMEngine:
        model = (body or {}).get("model")
        if (not self.lora_root or not model or model == self.model_id
                or ":" not in str(model)):
            return self.engine
        adapter_id = str(model).rsplit(":", 1)[1]
        evicted = []
        with self._lora_lock:
            eng = self._lora_engines.get(adapter_id)
            if eng is not None:
                self._lora_engines.move_to_end(adapter_id)
                return eng
            eng = self._build_lora_engine(adapter_id)
            while len(self._lora_engines) >= self.max_loras:
                evicted.append(self._lora_engines.popitem(last=False)[1])
            self._lora_engines[adapter_id] = eng
        for old in evicted:   # on this request's thread, outside the lock
            old.shutdown()
        return eng

    def _build_lora_engine(self, adapter_id: str) -> LLMEngine:
        from ray_tpu_torch.models.gpt2 import apply_lora, load_lora_npz
        from ray_tpu_torch.serve import weight_store as _ws
        from ray_tpu_torch.utils import fs

        # hot-swap path: adapter deltas are weight-plane objects. The
        # first replica to load an adapter publishes it; every later one
        # pulls it P2P instead of touching lora_root (the same bytes, so
        # the same merge). A miss falls back to the npz, then publishes.
        adapter = None
        store = _ws.get_store()
        akey = _ws.adapter_store_key(self.engine.weights_id, adapter_id)
        if store is not None:
            try:
                adapter = store.fetch_adapter(akey, tenant=adapter_id)
            except Exception:
                adapter = None
        if adapter is None:
            adapter = load_lora_npz(fs.join(self.lora_root,
                                            f"{adapter_id}.npz"))
            if store is not None:
                try:
                    store.publish_adapter(akey, adapter)
                except Exception:
                    pass
        merged = apply_lora(self.engine.params, adapter)
        kwargs = dict(self._engine_kwargs)
        kwargs.pop("checkpoint", None)
        kwargs.pop("cluster_prefix_cache", None)
        # the merged params have the base engine's architecture (maybe a
        # checkpoint's, not the preset's), and adapters share the base's
        # prefix-store entries, as in the JAX package
        kwargs.update(cfg_override=self.engine.cfg,
                      weights_id=self.engine.weights_id,
                      device=self.engine.device)
        return LLMEngine(params_override=merged, **kwargs)

    def stream_next(self, stream_id: str, cursor: int = 0) -> dict:
        eng, ids = self._stream_owner.get(stream_id, (self.engine, None))
        try:
            out = eng.stream_next(stream_id, cursor=cursor)
        except KeyError:
            self._stream_owner.pop(stream_id, None)   # expired engine-side
            raise
        if out.get("done"):
            self._stream_owner.pop(stream_id, None)
            if ids is not None and not out.get("error"):
                self._publish_prefix(eng, ids)
        return out

    def _note_stream(self, sid: str, eng, ids=None) -> None:
        # abandoned SSE clients leave entries behind: bound the map (the
        # engines sweep their own stream state)
        if len(self._stream_owner) > 1024:
            for k in list(self._stream_owner)[:512]:
                self._stream_owner.pop(k, None)
        self._stream_owner[sid] = (eng, ids)

    def __call__(self, request: Any) -> dict:
        path = getattr(request, "path", "/v1/completions")
        if path.endswith("/models"):
            data = [{"id": self.model_id, "object": "model",
                     "owned_by": "ray_tpu"}]
            data += [{"id": f"{self.model_id}:{a}", "object": "model",
                      "owned_by": "ray_tpu", "parent": self.model_id}
                     for a in self.loaded_lora_ids()]
            return {"object": "list", "data": data}
        body = request if isinstance(request, dict) else \
            getattr(request, "json", None) or {}
        max_tokens = int(body.get("max_tokens", 16))
        temperature = float(body.get("temperature", 1.0))
        top_p = float(body.get("top_p", 1.0))
        top_k = int(body.get("top_k", 0))
        stream = bool(body.get("stream"))
        eng = self._engine_for(body)
        tenant = self._tenant_of(body)
        chat = path.endswith("/chat/completions")
        if chat:
            msgs = body.get("messages", [])
            prompt = "".join(f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
                             for m in msgs) + "<|assistant|>"
            ids = self._request_ids(eng, {}, prompt)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            ids = self._request_ids(eng, body, prompt)
        sampling = dict(max_tokens=max_tokens, temperature=temperature,
                        top_k=top_k, top_p=top_p,
                        prefix_future=self._warm_start_future(
                            eng, ids, tenant=tenant))
        if stream:
            sid = eng.start_stream(prompt_ids=ids, **sampling)
            self._note_stream(sid, eng, ids)
            return {"__sse_stream__": {"stream_id": sid,
                                       "model": self.model_id,
                                       "mode": "chat" if chat
                                       else "completion"}}
        out = eng.generate(prompt_ids=ids, **sampling)
        self._publish_prefix(eng, ids)
        finish = ("length" if out["completion_tokens"] >= max_tokens
                  else "stop")
        usage = {"prompt_tokens": out["prompt_tokens"],
                 "completion_tokens": out["completion_tokens"],
                 "total_tokens": out["prompt_tokens"]
                 + out["completion_tokens"]}
        if chat:
            return {"id": f"chatcmpl-{int(time.time() * 1e3)}",
                    "object": "chat.completion", "model": self.model_id,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant",
                                             "content": out["text"]},
                                 "finish_reason": finish}],
                    "usage": usage}
        return {"id": f"cmpl-{int(time.time() * 1e3)}",
                "object": "text_completion", "model": self.model_id,
                "choices": [{"index": 0, "text": out["text"],
                             "finish_reason": finish}],
                "usage": usage}

    def shutdown(self):
        with self._lora_lock:
            engines = list(self._lora_engines.values())
            self._lora_engines.clear()
        for eng in engines:
            eng.shutdown()
        super().shutdown()
