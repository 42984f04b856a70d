"""Gossiped object directory: object → serving-node resolution, head-free.

Reference: `src/ray/object_manager/ownership_object_directory.cc` — every
consumer of an object must learn which node can serve its bytes. PRs 1-3
decentralized the control plane, but object location lookups remained a
head round trip (`locate_object`) and the head's directory died with it.

This module piggybacks object-location announcements on the gossip plane
that already exists (zero new RPC channels, the flight-recorder pattern):

- the **head** stays the authority: every seal/spill/free of a non-inline
  object appends a small delta record, and the records ride the next
  `cluster_view` broadcast (debounced by `view_broadcast_s`, so a put
  storm costs one list per tick, not one push per object);
- **node daemons** and **drivers** apply the records into a cached
  `ObjectDirectory`; a warm `get()` of a remote object resolves the
  serving node (and its data-server address, now carried in the view
  entries) entirely from cache — zero head RPCs;
- **pulled replicas** (a daemon's pull-manager cache) are announced back
  to the head on `resource_view_delta` gossip and rebroadcast, giving
  every consumer multi-source failover;
- on daemon (re)connect the directory entries for the daemon's OWN node
  are re-advertised through the `pool_reconcile` handshake, so a
  restarted head rebuilds the directory from daemon truth — the
  head-restart ledger pattern applied to data (shm objects now survive head restarts).

Record shapes (plain dicts, pickled inside the existing frames):
  {"op": "seal",  "meta": ObjectMeta}              # new/updated primary
  {"op": "spill", "meta": ObjectMeta}              # retargeted to disk
  {"op": "free",  "oid": bytes}                    # object gone
  {"op": "replica", "oid": bytes, "node": hex}     # extra pull source
  {"op": "replica_gone", "oid": bytes, "node": hex}
  {"op": "node_dead", "node": hex}                 # purge its locations
  {"op": "prefix", "mk": str, "ph": bytes, "oid": bytes,
   "n": int, "bs": int}                            # content-addressed KV
  {"op": "prefix_gone", "mk": str, "ph": bytes}    # binding withdrawn
  {"op": "weights", "wid": str, "oid": bytes}      # weights_id -> manifest
  {"op": "weights_gone", "wid": str}               # weights withdrawn

Weights rows are the serve plane's model-fleet index
(serve/weight_store.py): a weights identity (checkpoint path, preset@seed,
or adapter key) bound to the object id of a published weight-manifest
blob. A cold replica resolves `weights_id -> manifest` from its cached
directory with zero head RPCs and streams the manifest's chunk objects
from peers instead of re-reading the checkpoint from a central path.
Like prefix rows, a binding dies with its blob.

Prefix rows are the serve plane's cluster-wide KV cache index: a rolling
content hash of a token prefix (serve/prefix_store.py) bound to the
object id of an exported paged-KV blob. They ride the same broadcast as
location records, so ANY replica resolves "who already computed this
prefix" from cache — zero head RPCs on the warm path. A binding dies
with its blob: free/node-death records purge the rows of objects whose
bytes are gone, so a lookup never returns an unreachable prefix.

Broadcast payloads:
  {"v": seq, "delta": [records...]}                # normal tick
  {"v": seq, "full": [ {"meta": m, "replicas": [hex...]} ... ]}
Gaps are harmless: records are absolute facts, and a consumer that
missed a batch simply cold-misses into the head fallback.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from ray_tpu_torch.core.ids import ObjectID

# kinds a data server can actually serve bytes for; device objects live
# in their owner process and inline ones ride the control plane whole
PULLABLE_KINDS = ("shm", "arena", "spilled")


def seal_record(meta) -> dict:
    return {"op": "seal", "meta": meta}


def spill_record(meta) -> dict:
    return {"op": "spill", "meta": meta}


def free_record(oid: ObjectID) -> dict:
    return {"op": "free", "oid": oid.binary()}


def replica_record(oid: ObjectID, node_hex: str) -> dict:
    return {"op": "replica", "oid": oid.binary(), "node": node_hex}


def replica_gone_record(oid: ObjectID, node_hex: str) -> dict:
    return {"op": "replica_gone", "oid": oid.binary(), "node": node_hex}


def node_dead_record(node_hex: str) -> dict:
    return {"op": "node_dead", "node": node_hex}


def prefix_record(model_key: str, phash: bytes, oid: ObjectID,
                  n_tokens: int, block_size: int) -> dict:
    return {"op": "prefix", "mk": model_key, "ph": phash,
            "oid": oid.binary(), "n": int(n_tokens), "bs": int(block_size)}


def prefix_gone_record(model_key: str, phash: bytes) -> dict:
    return {"op": "prefix_gone", "mk": model_key, "ph": phash}


def weights_record(weights_id: str, oid: ObjectID) -> dict:
    return {"op": "weights", "wid": weights_id, "oid": oid.binary()}


def weights_gone_record(weights_id: str) -> dict:
    return {"op": "weights_gone", "wid": weights_id}


def resolve_addrs(directory: "ObjectDirectory", meta, addr_of,
                  default_host: str, exclude: Optional[str] = None) -> list:
    """Shared pull-source resolution: the directory's locations for the
    object (primary first, replicas after; the meta's own node stamp as
    the cold fallback) mapped to data-server addresses through `addr_of`
    (a node-hex → (host, port)|None lookup — the cached cluster view for
    clients/daemons, the node table for the head). A None host means
    "the head's host" and is substituted with `default_host`; `exclude`
    skips the caller's own node (never pull from yourself). Every party
    (client, node daemon, head) resolves through this one helper so
    ordering and host-substitution semantics cannot drift."""
    if meta.kind not in PULLABLE_KINDS:
        return []
    node_hexes = directory.locations(meta.object_id)
    if not node_hexes and meta.node_id is not None:
        node_hexes = [meta.node_id.hex()]
    out = []
    for h in node_hexes:
        if exclude is not None and h == exclude:
            continue
        addr = addr_of(h)
        if addr:
            out.append((addr[0] or default_host, addr[1]))
    return out


class _Entry:
    __slots__ = ("meta", "replicas", "primary_dead")

    def __init__(self, meta, replicas: Optional[Set[str]] = None):
        self.meta = meta
        self.replicas = replicas or set()
        # primary node died but a replica survived: the entry lives on
        # (replicas serve by object-id translation), and dies with the
        # last replica
        self.primary_dead = False


class ObjectDirectory:
    """One party's view of where object bytes live.

    The head holds the authoritative copy (fed by `apply_record` as it
    seals/spills/frees); daemons and drivers hold cached copies fed by
    broadcast payloads. Entries keep the full ObjectMeta — that is what
    makes daemon re-advertisement after a head restart possible, and what
    lets a driver `get()` an object it never held a meta for without
    asking the head."""

    def __init__(self):
        self.entries: Dict[ObjectID, _Entry] = {}
        # content-addressed KV prefix index: model_key -> prefix chain
        # hash -> {"oid", "n", "bs"}; _prefix_by_oid is the reverse index
        # that lets free/node-death records purge bindings in O(1)
        self.prefixes: Dict[str, Dict[bytes, dict]] = {}
        self._prefix_by_oid: Dict[ObjectID, Set[tuple]] = {}
        # content-addressed weight index: weights_id -> {"oid"} of the
        # published manifest blob; _weights_by_oid mirrors the prefix
        # reverse index so free/node-death purges bindings in O(1)
        self.weights: Dict[str, dict] = {}
        self._weights_by_oid: Dict[ObjectID, Set[str]] = {}
        self.last_v = 0           # highest broadcast version applied
        self.adopted_ts = 0.0     # monotonic ts of the last applied payload
        self.applied_records = 0  # lifetime counter (tests/diagnostics)

    def __len__(self) -> int:
        return len(self.entries)

    # -------------------------------------------------------------- reads
    def lookup_meta(self, oid: ObjectID):
        ent = self.entries.get(oid)
        return ent.meta if ent is not None else None

    def locations(self, oid: ObjectID) -> List[str]:
        """Node hexes that can serve the object, primary first."""
        ent = self.entries.get(oid)
        if ent is None:
            return []
        out = []
        if ent.meta.node_id is not None and not ent.primary_dead:
            out.append(ent.meta.node_id.hex())
        out.extend(h for h in sorted(ent.replicas) if h not in out)
        return out

    def metas_on(self, node_hex: str) -> List[object]:
        """Primary metas living on one node (daemon re-advertisement)."""
        return [ent.meta for ent in self.entries.values()
                if ent.meta.node_id is not None
                and ent.meta.node_id.hex() == node_hex]

    def replicas_on(self, node_hex: str) -> List[ObjectID]:
        return [oid for oid, ent in self.entries.items()
                if node_hex in ent.replicas]

    def staleness_s(self) -> float:
        """Seconds since the last applied broadcast; -1 = never."""
        if not self.adopted_ts:
            return -1.0
        return time.monotonic() - self.adopted_ts

    def longest_prefix(self, model_key: str, chain) -> Optional[dict]:
        """Longest announced prefix binding covering a prompt, entirely
        from cache. `chain` is the prompt's rolling chain hashes in
        prefix order (block 1..k, serve/prefix_store.chain_hashes);
        walked longest-first, the first binding whose blob is still
        RESIDENT somewhere (its oid resolves in the location entries)
        wins — a binding that outlived its bytes is skipped, never
        returned as a warm hit. Returns {"ph", "oid", "n", "bs"}."""
        rows = self.prefixes.get(model_key)
        if not rows:
            return None
        for phash in reversed([h for h, _n in chain]):
            ent = rows.get(phash)
            if ent is None:
                continue
            if ObjectID(ent["oid"]) in self.entries:
                return {"ph": phash, **ent}
        return None

    def prefix_count(self) -> int:
        return sum(len(rows) for rows in self.prefixes.values())

    def weights_binding(self, weights_id: str) -> Optional[dict]:
        """Resident manifest binding for a weights identity, entirely
        from cache. Residency-checked like `longest_prefix`: a binding
        whose manifest blob is gone everywhere is never returned — the
        caller falls back to the checkpoint-path read instead of chasing
        an unreachable object. Returns {"oid"} or None."""
        ent = self.weights.get(weights_id)
        if ent is None:
            return None
        if ObjectID(ent["oid"]) not in self.entries:
            return None
        return dict(ent)

    def weights_count(self) -> int:
        return len(self.weights)

    def _drop_weights(self, weights_id: str) -> None:
        ent = self.weights.pop(weights_id, None)
        if ent is None:
            return
        oid = ObjectID(ent["oid"])
        wids = self._weights_by_oid.get(oid)
        if wids is not None:
            wids.discard(weights_id)
            if not wids:
                self._weights_by_oid.pop(oid, None)

    def _purge_weights_for(self, oid: ObjectID) -> None:
        """The manifest blob's bytes are gone everywhere: its weights
        bindings must not linger as phantom warm starts."""
        for wid in list(self._weights_by_oid.pop(oid, ())):
            self.weights.pop(wid, None)

    def _drop_prefix(self, model_key: str, phash: bytes) -> None:
        rows = self.prefixes.get(model_key)
        ent = rows.pop(phash, None) if rows else None
        if ent is None:
            return
        if not rows:
            self.prefixes.pop(model_key, None)
        oid = ObjectID(ent["oid"])
        keys = self._prefix_by_oid.get(oid)
        if keys is not None:
            keys.discard((model_key, phash))
            if not keys:
                self._prefix_by_oid.pop(oid, None)

    def _purge_prefixes_for(self, oid: ObjectID) -> None:
        """The blob's bytes are gone everywhere: its bindings must not
        linger as phantom warm hits."""
        for model_key, phash in list(self._prefix_by_oid.pop(oid, ())):
            rows = self.prefixes.get(model_key)
            if rows is not None:
                rows.pop(phash, None)
                if not rows:
                    self.prefixes.pop(model_key, None)

    # ------------------------------------------------------------- writes
    def apply_record(self, rec: dict) -> None:
        op = rec.get("op")
        if op in ("seal", "spill"):
            meta = rec["meta"]
            if meta.kind not in PULLABLE_KINDS:
                return
            ent = self.entries.get(meta.object_id)
            if ent is None:
                self.entries[meta.object_id] = _Entry(meta)
            else:
                # spill retarget / re-seal keeps replica knowledge
                ent.meta = meta
        elif op == "free":
            oid = ObjectID(rec["oid"])
            self.entries.pop(oid, None)
            self._purge_prefixes_for(oid)
            self._purge_weights_for(oid)
        elif op == "replica":
            ent = self.entries.get(ObjectID(rec["oid"]))
            if ent is not None:
                ent.replicas.add(rec["node"])
        elif op == "replica_gone":
            oid = ObjectID(rec["oid"])
            ent = self.entries.get(oid)
            if ent is not None:
                ent.replicas.discard(rec["node"])
                if ent.primary_dead and not ent.replicas:
                    # that was the last copy anywhere: a primary-dead
                    # entry must not linger unreachable forever
                    del self.entries[oid]
                    self._purge_prefixes_for(oid)
                    self._purge_weights_for(oid)
        elif op == "node_dead":
            dead = rec["node"]
            for oid in list(self.entries):
                ent = self.entries[oid]
                ent.replicas.discard(dead)
                if ent.meta.node_id is not None \
                        and ent.meta.node_id.hex() == dead:
                    ent.primary_dead = True
                if ent.primary_dead and not ent.replicas:
                    # nobody holds the bytes anymore. While a replica
                    # survives the entry stays: pulls fail over to it
                    # (its data server translates the canonical meta to
                    # its local copy by object id) — losing the primary
                    # is exactly when replica knowledge matters most
                    del self.entries[oid]
                    self._purge_prefixes_for(oid)
                    self._purge_weights_for(oid)
        elif op == "prefix":
            mk, phash = rec["mk"], rec["ph"]
            self._drop_prefix(mk, phash)   # rebind: retire the old oid
            self.prefixes.setdefault(mk, {})[phash] = {
                "oid": rec["oid"], "n": rec["n"], "bs": rec["bs"]}
            self._prefix_by_oid.setdefault(
                ObjectID(rec["oid"]), set()).add((mk, phash))
        elif op == "prefix_gone":
            self._drop_prefix(rec["mk"], rec["ph"])
        elif op == "weights":
            wid = rec["wid"]
            self._drop_weights(wid)    # rebind: retire the old oid
            self.weights[wid] = {"oid": rec["oid"]}
            self._weights_by_oid.setdefault(
                ObjectID(rec["oid"]), set()).add(wid)
        elif op == "weights_gone":
            self._drop_weights(rec["wid"])
        self.applied_records += 1

    def apply(self, payload: Optional[dict]) -> bool:
        """Apply one broadcast payload (delta or full). Stale payloads
        (version at or below what we already applied) are dropped —
        except `full`, which is a wholesale resync and always wins."""
        if not payload:
            return False
        v = payload.get("v", 0)
        full = payload.get("full")
        if full is not None:
            self.entries = {
                e["meta"].object_id: _Entry(e["meta"],
                                            set(e.get("replicas") or ()))
                for e in full if e["meta"].kind in PULLABLE_KINDS}
            self.prefixes = {}
            self._prefix_by_oid = {}
            self.weights = {}
            self._weights_by_oid = {}
            for rec in payload.get("prefixes") or ():
                self.apply_record(rec)
            for rec in payload.get("weights") or ():
                self.apply_record(rec)
            self.last_v = v
            self.adopted_ts = time.monotonic()
            self.applied_records += 1
            return True
        if v and v <= self.last_v:
            return False
        for rec in payload.get("delta") or ():
            self.apply_record(rec)
        self.last_v = max(self.last_v, v)
        self.adopted_ts = time.monotonic()
        return True

    def full_payload(self, v: int) -> dict:
        """Wholesale snapshot for late joiners / (re)registered daemons."""
        return {"v": v,
                "full": [{"meta": ent.meta,
                          "replicas": sorted(ent.replicas)}
                         for ent in self.entries.values()],
                "prefixes": [
                    {"op": "prefix", "mk": mk, "ph": ph, "oid": e["oid"],
                     "n": e["n"], "bs": e["bs"]}
                    for mk, rows in self.prefixes.items()
                    for ph, e in rows.items()],
                "weights": [
                    {"op": "weights", "wid": wid, "oid": e["oid"]}
                    for wid, e in self.weights.items()]}
