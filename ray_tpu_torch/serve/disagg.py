"""Disaggregated prefill/decode serving over the object data plane
(counterpart of `ray_tpu/serve/disagg.py`).

The serve controller places two replica sets, a prefill pool
(`PrefillServer`) and a decode pool (`DisaggLLMServer`), as separate
deployments (`build_disagg_llm_deployment`; distinct resource labels steer
them to separately provisioned nodes). The KV path is the object data
plane, not the head:

  decode replica --(deployment handle call)--> prefill replica
      the prefill replica runs the prompt pass, exports the pooled blocks
      and seals the blob into its node's object store (a small blob rides
      the reply); the ObjectRef travels back in the reply.
  decode replica --(P2P pull)--> prefill node
      the decode side waits, bounded, for the gossiped object directory to
      learn the blob's location, then pulls it through its node (one
      network crossing, zero head RPCs on the warm path) and the engine
      imports the blocks at admission, skipping prefill for that span.

Every export is also published into the cluster prefix store
(`serve/prefix_store.py`), so a later request for the same prefix, on any
replica, warm-starts from the store without calling the prefill pool. A
dead prefill pool, a lost blob or a store miss just means the decode
engine prefills locally: correctness never depends on the transfer.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.llm import LLMServer


class _RpcAudit:
    """Head-RPC audit hooks for acceptance drills and ops debugging:
    records this process's head-connection traffic between start/stop
    (the zero-head-RPCs-on-the-warm-path contract is verified from inside
    the replica, where the KV shipping happens)."""

    def __init__(self):
        self._events: List[tuple] = []
        self._hook = None

    def start(self) -> bool:
        from ray_tpu_torch.core import protocol

        if self._hook is not None:
            return False
        events = self._events = []

        def hook(conn_name, kind, method):
            if conn_name == "head":
                events.append((kind, method))

        protocol.add_rpc_interposer(hook)
        self._hook = hook
        return True

    def stop(self) -> List[tuple]:
        from ray_tpu_torch.core import protocol

        if self._hook is not None:
            protocol.remove_rpc_interposer(self._hook)
            self._hook = None
        events, self._events = self._events, []
        return events


class PrefillServer:
    """Prefill-pool replica: runs prompt passes and exports KV blobs into
    the object store for decode replicas to pull. Every export is also
    PUBLISHED into the cluster prefix store (content hash -> blob binding
    on the gossiped directory)."""

    def __init__(self, cluster_prefix_cache: bool = True, **engine_kwargs):
        from ray_tpu_torch.serve.llm import LLMEngine

        engine_kwargs.setdefault("enable_prefix_caching", True)
        self.engine = LLMEngine(**engine_kwargs)
        self.prefix_store = None
        if cluster_prefix_cache and self.engine.kv is not None:
            from ray_tpu_torch.serve import prefix_store as _ps

            self.prefix_store = _ps.store_for_engine(self.engine)
        self._lock = threading.Lock()
        self.prefills = 0
        self.blobs_exported = 0
        self.tokens_exported = 0
        self._audit = _RpcAudit()

    def prefill(self, prompt_ids: List[int]) -> Dict[str, Any]:
        """Run (or reuse) the prompt's prefill and ship its KV blocks to
        the decode caller. A blob past the store's inline threshold seals
        into the object store (the ref rides back in the reply; the bytes
        stay on this node until the decode replica pulls them). A smaller
        blob rides the reply itself: inline objects never enter the
        gossiped directory, so a store round trip would buy nothing."""
        import ray_tpu_torch
        from ray_tpu_torch.core.store import INLINE_THRESHOLD

        with self._lock:
            self.prefills += 1
        blob = self.engine.export_prefix(prompt_ids=list(prompt_ids))
        if blob is None or not blob.get("ids"):
            return {"ref": None, "n_tokens": 0}
        with self._lock:
            self.blobs_exported += 1
            self.tokens_exported += len(blob["ids"])
        out = {"n_tokens": len(blob["ids"]), "block_size": blob["block_size"]}
        if blob["k"].nbytes + blob["v"].nbytes <= INLINE_THRESHOLD:
            return {**out, "blob": blob}
        ref = ray_tpu_torch.put(blob)
        if self.prefix_store is not None:
            # publish-on-prefill: bind the content hash to THIS blob so the
            # whole cluster shares the export (the store pins its own ref;
            # pin-level dedup keeps re-prefills from re-announcing)
            try:
                self.prefix_store.publish(blob, ref=ref)
            except Exception:
                pass
        return {**out, "ref": ref}

    def live_signal_extra(self) -> dict:
        """Resident-prefix routing hint for this replica's load row (read
        by the serve router's prefix-affinity pick, `serve/handle.py`)."""
        if self.engine.kv is None:
            return {}
        return {"prefix_roots":
                [h.hex() for h in self.engine.kv.recent_chain_hashes()]}

    def stats(self) -> dict:
        out = self.engine.engine_stats()
        with self._lock:
            out.update({"role": "prefill", "prefills": self.prefills,
                        "blobs_exported": self.blobs_exported,
                        "tokens_exported": self.tokens_exported})
        if self.engine.kv is not None:
            out["kv_cache"] = self.engine.kv.stats()
        if self.prefix_store is not None:
            out["prefix_store"] = self.prefix_store.stats()
        return out

    def rpc_audit_start(self) -> bool:
        return self._audit.start()

    def rpc_audit_stop(self) -> List[tuple]:
        return self._audit.stop()

    def check_health(self):
        if not self.engine._thread.is_alive():
            raise RuntimeError("prefill engine loop died")


class DisaggLLMServer(LLMServer):
    """Decode-pool replica: completions API surface; prompts whose KV
    isn't resident fall through the residency tiers — local engine pool,
    cluster prefix store (any replica's export, via the gossiped
    directory + P2P pull, zero head RPCs warm), prefill pool RPC — and
    the blob import overlaps decode of other lanes instead of blocking
    the request thread."""

    def __init__(self, prefill_handle=None, directory_wait_s: float = 2.0,
                 prefill_timeout_s: float = 120.0,
                 cluster_prefix_cache: bool = True, **engine_kwargs):
        engine_kwargs.setdefault("enable_prefix_caching", True)
        super().__init__(cluster_prefix_cache=cluster_prefix_cache,
                         **engine_kwargs)
        # arrives as a live DeploymentHandle via deployment composition
        self.prefill_handle = prefill_handle
        self.directory_wait_s = directory_wait_s
        self.prefill_timeout_s = prefill_timeout_s
        self._lock = threading.Lock()
        self.prefill_fetches = 0
        self.plane_fetches = 0      # blobs pulled via the object data plane
        self.store_fetches = 0      # blobs resolved from the cluster store
        self.local_prefix_hits = 0
        self.fetch_errors = 0
        self._audit = _RpcAudit()

    # ------------------------------------------------------- KV fetching
    def _wait_directory(self, ref) -> bool:
        """Bounded wait for the gossiped object directory to resolve the
        blob to a serving node: the announcement rides the cluster_view
        broadcast, so a beat of patience buys a head-free P2P pull
        (timeout falls back to the cold-miss path inside get())."""
        try:
            from ray_tpu_torch.core.api import _global_client

            client = _global_client()
        except Exception:
            return False
        deadline = time.monotonic() + self.directory_wait_s
        while time.monotonic() < deadline:
            try:
                if ref.id in client.local_metas:
                    return True     # same-node blob: already local
                locs = client.object_dir.locations(ref.id)
                if locs and any(client.cluster_view.data_addr_of(h)
                                for h in locs):
                    return True
            except Exception:
                return False
            time.sleep(0.01)
        return False

    def _prefix_future(self, ids: List[int]):
        """Async prefill fetch: kick the residency-tier fall-through onto
        the prefetch executor and hand the engine a blob future — the
        request thread enqueues immediately and OTHER lanes keep decoding
        while this prompt's KV crosses the network (the engine imports on
        its own thread at admission). None when the local pool already
        covers the prompt (a full block of gain is the bar — below that
        the fetch costs more than the prefill it saves)."""
        if self.engine.kv is None or len(ids) < 2:
            return None
        if self.prefill_handle is None and self.prefix_store is None:
            return None
        kv = self.engine.kv
        covered = kv.peek_prefix_len(ids[:-1])
        if (len(ids) - 1) - covered < kv.block_size:
            with self._lock:
                self.local_prefix_hits += 1
            return None
        return self._prefix_submit(self._fetch_prefix_blob, list(ids),
                                   covered)

    def _fetch_prefix_blob(self, ids: List[int],
                          covered: int) -> Optional[dict]:
        """Executor thread: cluster store first (directory lookup from
        cache + P2P pull — zero head RPCs on the warm path, no prefill
        RPC at all), then the prefill pool with a prefix-affinity routing
        hint. None on total failure: decode-local prefill is always
        correct."""
        kv = self.engine.kv
        need = ids[:-1]
        store = self.prefix_store
        if store is not None:
            hit = store.lookup(need)
            if hit is not None and hit["n"] > covered:
                # a store hit only replaces the prefill RPC when it
                # covers most of the uncovered prompt: a shallow hit on a
                # long prompt would leave the decode replica prefilling
                # the long tail locally — exactly what disaggregation
                # exists to avoid — so those fall through to the pool
                # (affinity-routed to the replica holding the prefix)
                remaining_after = len(need) - hit["n"]
                deep_enough = remaining_after <= max(
                    kv.block_size, (len(need) - covered) // 2)
                if deep_enough or self.prefill_handle is None:
                    blob = store.fetch(hit)
                    if blob is not None:
                        with self._lock:
                            self.store_fetches += 1
                        return blob
                    # owner died / blob gone mid-fetch: fall through to
                    # the prefill pool (which re-exports and re-announces)
        if self.prefill_handle is None:
            return None
        try:
            from ray_tpu_torch.serve.kv_cache import chain_hashes

            h = self.prefill_handle.options(
                method_name="prefill",
                prefix_hint=[ph.hex() for ph, _n in
                             chain_hashes(need, kv.block_size)])
            res = h.remote(list(ids)).result(timeout=self.prefill_timeout_s)
            blob = res.get("blob")
            via_plane = blob is None
            if via_plane:
                ref = res.get("ref")
                if ref is None:
                    return None
                self._wait_directory(ref)
                blob = ray_tpu_torch.get(ref, timeout=self.prefill_timeout_s)
            with self._lock:
                self.prefill_fetches += 1
                self.plane_fetches += 1 if via_plane else 0
            # the blob ref is dropped here, not free()d: free is a head
            # round trip, while a dropped borrow GCs through the refcount
            # plane's batched pushes — the warm path stays head-RPC-free
            return blob
        except Exception:
            # degraded mode: decode-side prefill (correct, just slower)
            with self._lock:
                self.fetch_errors += 1
            return None

    def prefix_store_probe(self, prompt_ids: List[int]) -> Optional[int]:
        """Debug/drill surface: covered-token count the cluster store
        would warm-start this prompt with right now (cached directory
        only — no fetch, and uncounted so polls don't skew the hit/miss
        counters)."""
        if self.prefix_store is None:
            return None
        hit = self.prefix_store.lookup(list(prompt_ids), count=False)
        return None if hit is None else hit["n"]

    # ---------------------------------------------------------- requests
    def __call__(self, request: Any) -> dict:
        body = request if isinstance(request, dict) else getattr(
            request, "json", None) or {}
        ids = self._request_ids(self.engine, body)
        out = self.engine.generate(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            prefix_future=self._prefix_future(ids),
            prefix_wait_s=self.prefill_timeout_s,
            # the fetch wait parks INSIDE generate now (the old sync
            # _ensure_prefix ran before it): the deadline must cover the
            # full fetch window PLUS the decode budget
            timeout=self.prefill_timeout_s + 120.0)
        # Degraded-mode decode-local prefills (prefill pool down, store
        # miss) are prefix-cache material like any other: publish them so
        # the NEXT replica to see this prefix warm-starts from the store
        # instead of re-prefilling. Content-addressed dedup in
        # maybe_publish makes the warm-path case (prefix was imported,
        # nothing newly computed) a no-op.
        self._publish_prefix(self.engine, ids)
        return {
            "object": "text_completion",
            "choices": [{"text": out["text"], "index": 0,
                         "token_ids": out["token_ids"],
                         "finish_reason": "length"}],
            "usage": {"prompt_tokens": out["prompt_tokens"],
                      "completion_tokens": len(out["token_ids"])},
        }

    def stats(self) -> dict:
        out = super().stats()
        kv = self.engine.kv
        with self._lock:
            out.update({"role": "decode",
                        "prefill_fetches": self.prefill_fetches,
                        "plane_fetches": self.plane_fetches,
                        "store_fetches": self.store_fetches,
                        "blocks_imported":
                            self.engine.prefix_blocks_imported,
                        "tokens_imported":
                            self.engine.prefix_blocks_imported
                            * (kv.block_size if kv is not None else 0),
                        "local_prefix_hits": self.local_prefix_hits,
                        "fetch_errors": self.fetch_errors})
        return out

    def rpc_audit_start(self) -> bool:
        return self._audit.start()

    def rpc_audit_stop(self) -> List[tuple]:
        return self._audit.stop()


def build_disagg_llm_deployment(
        preset: str = "gpt2-tiny", max_seq_len: int = 128,
        name: str = "llm-disagg",
        prefill_replicas: int = 1, decode_replicas: int = 1,
        prefill_resources: Optional[dict] = None,
        decode_resources: Optional[dict] = None,
        prefill_max_batch: int = 2, decode_max_batch: int = 4,
        model_overrides: Optional[dict] = None,
        checkpoint: Optional[str] = None, seed: int = 0,
        kv_blocks: int = 64, kv_block_size: int = 16,
        num_gpus: int = 0,
        cluster_prefix_cache: bool = True,
        autoscaling_config=None, slo_config=None,
        **engine_kwargs):
    """Two-pool deployment graph: `{name}-prefill` and `{name}` (decode,
    the routable front). Distinct `*_resources` labels steer each pool's
    replicas through the two-level scheduler (e.g. prefill on
    compute-heavy nodes, decode on HBM-heavy nodes). Run with
    `serve.run(app, route_prefix=...)`; the returned handle fronts the
    decode pool. `num_gpus` GPUs go to every replica of both pools (the JAX
    package's `num_tpu_chips`); the engines run on `device` from
    `engine_kwargs`, CUDA by default (raising where there is none), so a
    CPU run passes `device="cpu"`."""
    from ray_tpu_torch.serve.api import deployment

    shared = dict(preset=preset, max_seq_len=max_seq_len, seed=seed,
                  model_overrides=model_overrides, checkpoint=checkpoint,
                  kv_blocks=kv_blocks, kv_block_size=kv_block_size,
                  cluster_prefix_cache=cluster_prefix_cache,
                  **engine_kwargs)
    pre_opts: Dict[str, Any] = {"num_cpus": 1}
    dec_opts: Dict[str, Any] = {"num_cpus": 1}
    if num_gpus:
        pre_opts["num_gpus"] = num_gpus
        dec_opts["num_gpus"] = num_gpus
    if prefill_resources:
        pre_opts["resources"] = dict(prefill_resources)
    if decode_resources:
        dec_opts["resources"] = dict(decode_resources)
    prefill = deployment(
        PrefillServer, name=f"{name}-prefill",
        num_replicas=prefill_replicas, ray_actor_options=pre_opts,
        max_ongoing_requests=prefill_max_batch * 2,
    ).bind(max_batch=prefill_max_batch, **shared)
    decode = deployment(
        DisaggLLMServer, name=name, num_replicas=decode_replicas,
        ray_actor_options=dec_opts,
        max_ongoing_requests=decode_max_batch * 2,
        autoscaling_config=autoscaling_config, slo_config=slo_config,
    ).bind(prefill_handle=prefill, max_batch=decode_max_batch, **shared)
    return decode
