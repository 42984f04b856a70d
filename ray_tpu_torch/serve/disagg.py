"""Disaggregated prefill serving over the object data plane, in part.

Counterpart of `ray_tpu/serve/disagg.py`'s `_RpcAudit` and `PrefillServer`.
A prefill replica runs prompt passes and exports each prompt's KV blocks
into its node's object store; a decode replica pulls the blob P2P (one
network crossing, zero head RPCs on the warm path) and skips prefill for
the covered span. Every export is also published into the cluster prefix
store (`serve/prefix_store.py`), so later requests for the same prefix, on
any replica, warm-start without calling the prefill pool at all.

The decode side, `DisaggLLMServer`, and `build_disagg_llm_deployment` call
the prefill pool through a serve `DeploymentHandle` and build serve
deployments: they are ROADMAP item 18b. A `PrefillServer` runs as a plain
actor or as the callable of a serve deployment.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List


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
