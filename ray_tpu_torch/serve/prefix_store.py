"""Cluster-wide content-addressed KV/prefix cache tier.

Counterpart of `ray_tpu/serve/prefix_store.py`. A shared prompt's prefill,
the expensive part of TTFT, is computed once per CLUSTER: paged-KV prefix
blobs are objects on the object data plane.

- **publish**: a replica that just prefilled a prompt exports its pooled
  blocks (`kv_cache.export_prefix`, host numpy), seals the blob into its
  node's shm store (`ray_tpu_torch.put`), pins the ref in a bounded LRU so
  the bytes stay alive, and announces `content hash -> blob object id` to
  the head with one fire-and-forget push. The binding rides the next
  cluster_view broadcast as a directory prefix row
  (`core/object_directory.py`).
- **lookup**: ANY replica resolves "who already computed this prefix" from
  its process-cached directory (the deepest fresh chain hash first,
  residency-checked) with ZERO RPCs. Same-process publications
  short-circuit through the pin table without waiting for gossip.
- **fetch**: the blob pulls through the node PullManager like any other
  object (one network crossing per node, LRU replica cache, multi-source
  failover): zero head RPCs on the warm path.

Residency tiers a request falls through, cheapest first: the replica's own
engine cache (`PagedKVCache.peek_prefix_len`) -> this process's pinned
publications -> any cluster replica via directory + P2P pull -> a prefill
pool -> local prefill. Every tier degrades to the next on any failure;
correctness never depends on a cache hit.

Multi-tenant: the store key is the BASE model's weight identity, so LoRA
adapters over one base share prefix entries; hit/miss counters are tagged
per tenant. Chain hashes and model keys are the JAX package's, byte for
byte.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from ray_tpu_torch.serve.kv_cache import chain_hashes

# ------------------------------------------------------------------ metrics
_metrics = None


def _get_metrics():
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util import metrics as m

        _metrics = {
            "hits": m.Counter(
                "prefix_store_hits_total",
                "Cluster prefix-store lookups that resolved a resident "
                "prefix blob", tag_keys=("tenant",)),
            "misses": m.Counter(
                "prefix_store_misses_total",
                "Cluster prefix-store lookups with no resident binding",
                tag_keys=("tenant",)),
            "bytes": m.Counter(
                "prefix_store_bytes_total",
                "KV bytes fetched from the cluster prefix store",
                tag_keys=("tenant",)),
            "inline_skipped": m.Counter(
                "prefix_store_inline_skipped_total",
                "Prefix blobs NOT published because they serialized "
                "below the object store's inline threshold "
                "(core/store.py INLINE_THRESHOLD, 100 KiB): inline "
                "objects ride actor replies instead of the sealed-object "
                "plane, so a directory binding could never serve a P2P "
                "pull. Small models / short prefixes land here — a "
                "nonzero count is WHY lookups miss, not a bug"),
        }
    return _metrics


def model_cache_key(weights_id: str, n_layer: int, n_head: int,
                    head_dim: int, dtype, block_size: int) -> str:
    """KV-compatibility key: two engines share prefix entries iff their
    keys match (same weights, same cache geometry). LoRA engines pass the
    BASE model's weights_id so adapters share base-model prefixes. The same
    string as the JAX package's for the same engine."""
    return (f"{weights_id}|L{n_layer}H{n_head}D{head_dim}"
            f"|{dtype}|bs{block_size}")


def _client():
    """The process's ray client, or None outside an initialized runtime
    (standalone engines in unit tests): every store operation silently
    no-ops without a cluster."""
    try:
        from ray_tpu_torch.core import api as core_api

        if not core_api.is_initialized():
            return None
        return core_api._global_client()
    except Exception:
        return None


def store_for_engine(engine, max_pins: int = 64,
                     fetch_timeout_s: float = 30.0
                     ) -> Optional["PrefixStoreClient"]:
    """Store client keyed by an LLMEngine's weight identity + cache
    geometry; None when the engine has no prefix cache to share."""
    key = engine.prefix_model_key
    if key is None:
        return None
    return PrefixStoreClient(key, engine.kv.block_size, max_pins=max_pins,
                             fetch_timeout_s=fetch_timeout_s)


class PrefixStoreClient:
    """One process's facade over the cluster prefix tier (thread-safe:
    replica request threads and prefetch executors share it)."""

    def __init__(self, model_key: str, block_size: int,
                 max_pins: int = 64, fetch_timeout_s: float = 30.0):
        self.model_key = model_key
        self.block_size = block_size
        self.max_pins = max_pins
        self.fetch_timeout_s = fetch_timeout_s
        # tip hash -> (ref, [(boundary hash, n_tokens), ...]): one pinned
        # blob serves EVERY block boundary it covers — a prompt sharing
        # only the system prefix of a published prompt still matches at
        # the shared depth
        self._pins: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._pin_rows: Dict[bytes, tuple] = {}   # boundary -> (tip, n)
        self._lock = threading.Lock()
        # lifetime counters (stats()/tests; the tagged Counters feed
        # /metrics): per-tenant hit/miss/fetch accounting
        self.hits = 0
        self.misses = 0
        self.fetches = 0
        self.fetch_errors = 0
        self.bytes_fetched = 0
        self.published = 0
        self.inline_skipped = 0
        self.reannounced = 0
        self.hits_by_tenant: Dict[str, int] = {}
        # head-restart resilience (the pool_reconcile pattern): the head
        # rebuilds prefix bindings from publisher truth — on reconnect
        # this client re-pushes announce rows for every live pin, so
        # bindings survive a head restart instead of waiting for the
        # next fresh export per prefix. Registered here AND retried at
        # publish time (a store built before ray_tpu_torch.init would
        # otherwise never arm the hook).
        self._reconnect_cb = None
        self._ensure_reconnect_hook(_client())

    def _ensure_reconnect_hook(self, client) -> None:
        """Idempotently arm the reconnect re-announce hook once a core
        client exists. WeakMethod: the client must not keep an evicted
        store alive; a fired hook whose store died self-unregisters."""
        if client is None or self._reconnect_cb is not None:
            return
        import weakref

        ref = weakref.WeakMethod(self.reannounce_pins)

        def _on_reconnect(_ref=ref, _client=client):
            m = _ref()
            if m is None:
                # store was GC'd: self-unregister so a long-lived
                # process recreating engines doesn't accumulate dead
                # closures on the shared client
                try:
                    _client.remove_reconnect_callback(_on_reconnect)
                except Exception:
                    pass
                return
            m()

        try:
            client.add_reconnect_callback(_on_reconnect)
            self._reconnect_cb = _on_reconnect
        except Exception:
            self._reconnect_cb = None

    # ------------------------------------------------------------- publish
    def _bound_in_directory(self, phash: bytes, client) -> bool:
        """Is this boundary already bound to a RESIDENT blob (announced by
        any replica, adopted from the broadcast)?"""
        try:
            from ray_tpu_torch.core.ids import ObjectID

            ent = (client.object_dir.prefixes.get(self.model_key)
                   or {}).get(phash)
            return (ent is not None
                    and ObjectID(ent["oid"]) in client.object_dir.entries)
        except Exception:
            return False

    def publish(self, blob: Optional[dict], ref=None) -> bool:
        """Seal an exported KV blob into the object store (or reuse a
        caller-provided `ref` of the already-sealed blob), pin it, and
        announce a content-address row at EVERY block boundary it covers
        — a later prompt that shares only the first j blocks still
        resolves this blob at depth j. Boundaries the cluster already has
        a resident binding for are skipped (shared prefixes are stored
        and announced once cluster-wide). Returns True when new bindings
        were announced. Sub-inline blobs are skipped: inline objects
        never enter the gossiped directory, so a binding for one could
        never serve a P2P warm start."""
        if not blob or not blob.get("ids"):
            return False
        client = _client()
        if client is None:
            return False
        self._ensure_reconnect_hook(client)
        chain = chain_hashes(list(blob["ids"]), self.block_size)
        if not chain:
            return False
        tip, _tip_n = chain[-1]
        with self._lock:
            if tip in self._pins:
                return False     # already published by this process
        rows = [(ph, n) for ph, n in chain
                if ph not in self._pin_rows
                and not self._bound_in_directory(ph, client)]
        if not rows:
            return False         # every boundary already served
        import ray_tpu_torch

        try:
            if ref is None:
                ref = ray_tpu_torch.put(blob)
            meta = client.local_metas.get(ref.id)
            from ray_tpu_torch.core.object_directory import PULLABLE_KINDS

            if meta is None or meta.kind not in PULLABLE_KINDS:
                # inline (< core/store.py INLINE_THRESHOLD = 100 KiB
                # serialized): rides actor replies, not the plane. Count
                # it, or a small model's lookups miss with no reason
                # shown.
                with self._lock:
                    self.inline_skipped += 1
                try:
                    _get_metrics()["inline_skipped"].inc()
                except Exception:
                    pass
                return False
            client.head_push(
                "announce_prefix", model_key=self.model_key,
                oid=ref.id.binary(), block_size=self.block_size,
                rows=rows)
        except Exception:
            return False
        evicted: Dict[bytes, list] = {}
        with self._lock:
            self._pins[tip] = (ref, rows)
            for ph, n in rows:
                self._pin_rows[ph] = (tip, n)
            self.published += 1
            while len(self._pins) > self.max_pins:
                _old_tip, (_old_ref, old_rows) = \
                    self._pins.popitem(last=False)
                for ph, _n in old_rows:
                    # a boundary rebound by a newer pin stays announced
                    if self._pin_rows.get(ph, (None,))[0] == _old_tip:
                        self._pin_rows.pop(ph, None)
                        evicted.setdefault(
                            _old_ref.id.binary(), []).append(ph)
        for old_oid, phashes in evicted.items():
            # dropping the ref releases the bytes through the refcount
            # plane; the explicit withdraw retires the bindings promptly
            # instead of leaving consumers to discover the free record.
            # oid-scoped: the head keeps a binding another replica has
            # since rebound to its own live blob
            try:
                client.head_push("withdraw_prefix",
                                 model_key=self.model_key, phashes=phashes,
                                 oid=old_oid)
            except Exception:
                pass
        return True

    def maybe_publish(self, kv, ids: List[int], exporter=None) -> bool:
        """Export + publish the prompt's pooled blocks unless the cluster
        already holds a resident binding for the full chain — shared
        prefixes are stored ONCE cluster-wide, so the dedup check runs
        before paying the device->host export copy. `exporter` overrides
        the raw pool export; engine callers pass `LLMEngine.export_pooled`
        so the copy runs on the engine thread (the pool is unlocked
        engine-owned state — a racing export could bind another request's
        bytes under this prompt's content hash)."""
        chain = chain_hashes(list(ids), self.block_size)
        if not chain:
            return False
        tip = chain[-1][0]
        with self._lock:
            if tip in self._pin_rows:
                return False
        client = _client()
        if client is not None and self._bound_in_directory(tip, client):
            return False           # another replica already owns it
        from ray_tpu_torch.serve.kv_cache import export_prefix

        if exporter is None:
            exporter = lambda i: export_prefix(kv, i)  # noqa: E731
        return self.publish(exporter(list(ids)))

    def reannounce_pins(self) -> int:
        """Re-push announce rows for every pinned publication (fired by
        the client's reconnect hook). The restarted head lost its prefix
        index; its objects come back through pool_reconcile, and these
        pushes rebind their content hashes — same source-of-truth
        inversion, zero new RPC channels. Idempotent head-side (a
        binding that already exists is overwritten with itself)."""
        client = _client()
        if client is None:
            return 0
        with self._lock:
            pins = [(ref, list(rows)) for ref, rows in self._pins.values()]
        n = 0
        for ref, rows in pins:
            try:
                client.head_push(
                    "announce_prefix", model_key=self.model_key,
                    oid=ref.id.binary(), block_size=self.block_size,
                    rows=rows)
                n += 1
            except Exception:
                pass
        with self._lock:
            self.reannounced += n
        return n

    # -------------------------------------------------------------- lookup
    def lookup(self, ids: List[int], tenant: str = "base",
               count: bool = True) -> Optional[dict]:
        """Longest resident prefix binding covering `ids`, zero RPCs:
        this process's pins first (no gossip round trip for same-process
        publications), then the broadcast-fed directory — whichever
        covers more tokens wins. Returns {"ph", "oid", "n", "bs"}.
        `count=False` keeps probes/polls out of the miss counters so they
        keep measuring request-path cache efficiency. HITS are counted on
        a successful `fetch` — a binding the caller never uses (too
        shallow for the disagg policy, or its fetch fails) is not cache
        efficiency."""
        chain = chain_hashes(list(ids), self.block_size)
        if not chain:
            return None
        best: Optional[dict] = None
        with self._lock:
            for phash, n_tokens in reversed(chain):
                owner = self._pin_rows.get(phash)
                if owner is None:
                    continue
                pinned = self._pins.get(owner[0])
                if pinned is not None:
                    best = {"ph": phash, "oid": pinned[0].binary(),
                            "n": owner[1], "bs": self.block_size}
                    break
        client = _client()
        if client is not None:
            try:
                hit = client.object_dir.longest_prefix(self.model_key,
                                                       chain)
            except Exception:
                hit = None
            if hit is not None and (best is None or hit["n"] > best["n"]):
                best = hit
        if count and best is None:
            with self._lock:
                self.misses += 1
            _get_metrics()["misses"].inc(tags={"tenant": tenant})
        return best

    # --------------------------------------------------------------- fetch
    def fetch(self, hit: dict, tenant: str = "base") -> Optional[dict]:
        """Pull a binding's blob over the object data plane (node
        PullManager: in-flight dedup, replica failover, LRU cache). None
        on any failure — the caller degrades to the next residency tier."""
        client = _client()
        if client is None:
            return None
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        try:
            blob = ray_tpu_torch.get(ObjectRef(ObjectID(hit["oid"])),
                               timeout=self.fetch_timeout_s)
        except Exception:
            with self._lock:
                self.fetch_errors += 1
            return None
        if not isinstance(blob, dict) or "k" not in blob:
            with self._lock:
                self.fetch_errors += 1
            return None
        size = int(blob["k"].nbytes + blob["v"].nbytes)
        with self._lock:
            self.fetches += 1
            self.bytes_fetched += size
            # a HIT is a blob the tier actually delivered: lookups whose
            # binding goes unused (shallow, or fetch fails) don't count
            self.hits += 1
            self.hits_by_tenant[tenant] = \
                self.hits_by_tenant.get(tenant, 0) + 1
        m = _get_metrics()
        m["hits"].inc(tags={"tenant": tenant})
        m["bytes"].inc(size, tags={"tenant": tenant})
        return blob

    # --------------------------------------------------------------- stats
    def pinned_hashes(self) -> List[bytes]:
        """Every boundary hash this process's pinned blobs can serve."""
        with self._lock:
            return list(self._pin_rows)

    def stats(self) -> dict:
        with self._lock:
            return {"model_key": self.model_key,
                    "block_size": self.block_size,
                    "pinned": len(self._pins),
                    "published": self.published,
                    "inline_skipped": self.inline_skipped,
                    "reannounced": self.reannounced,
                    "store_hits": self.hits,
                    "store_misses": self.misses,
                    "store_fetches": self.fetches,
                    "store_fetch_errors": self.fetch_errors,
                    "store_bytes_fetched": self.bytes_fetched,
                    "hits_by_tenant": dict(self.hits_by_tenant)}
