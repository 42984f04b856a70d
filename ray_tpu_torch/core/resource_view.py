"""Versioned cluster resource view — the `ray_syncer` equivalent.

Reference: `src/ray/common/ray_syncer/ray_syncer.h` — each node owns a
monotonically versioned snapshot of its local resource state and gossips
deltas; consumers keep a compacted cluster view and ignore stale versions.

Three parties share this module:

- the **head** (`gcs.py`) builds the authoritative compacted view: its own
  ledger supplies `free`/`total` per node, node-daemon deltas supply
  `idle_workers` (the daemon's warm lease pool) and `sched_addr`.  The view
  is broadcast (debounced) to node daemons and drivers.
- **node daemons** (`node_main.py`) gossip `{version, idle_workers,
  labels}` deltas to the head on change and cache the pushed cluster view.
- **clients** (`client.py`) cache the pushed view and use
  `select_node` for feasible-node lease routing: a lease request goes
  straight to the chosen node's daemon scheduler, touching the head only
  on infeasibility, version conflict (grant refused), or label miss.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def shard_of(node_id_hex: str, nshards: int) -> int:
    """Stable shard assignment for a node id. Node ids are random, so the
    first 32 bits are already uniform — no extra hashing needed, and every
    party (head, daemons, drivers, tests) computes the same shard."""
    if nshards <= 1:
        return 0
    return int(node_id_hex[:8] or "0", 16) % nshards


def matches_labels(labels: Dict[str, str],
                   selector: Optional[dict]) -> bool:
    """Shared label-selector semantics (NodeInfo and view entries must
    agree, or client-side routing and head-side granting diverge)."""
    if not selector:
        return True
    for k, v in selector.items():
        have = labels.get(k)
        if isinstance(v, (list, tuple, set)):   # "in" semantics
            if have not in v:
                return False
        elif have != str(v):
            return False
    return True


def fits(free: Dict[str, float], resources: Dict[str, float]) -> bool:
    return all(free.get(r, 0) >= amt - 1e-9 for r, amt in resources.items())


def make_entry(node_id_hex: str, *, version: int, free: Dict[str, float],
               total: Dict[str, float], labels: Dict[str, str],
               idle_workers: int = 0, sched_addr=None,
               data_addr=None, is_head: bool = False,
               store_frac=None, pool_shapes=None) -> dict:
    # data_addr: the node's object data server — consumers of the gossiped
    # object directory resolve pull sources from the cached view instead
    # of asking the head (host None = "the head's host", substituted by
    # each consumer from its own route to the head).
    # store_frac: that store's used/capacity fraction (None = unknown) —
    # the data plane's live memory-pressure signal.
    # pool_shapes: per-shape composition of the node's warm lease pool,
    # [[shape-pairs, count], ...] (shape = sorted (resource, amount)
    # pairs, the daemon's exact _pool_take key). None = the daemon
    # gossips no composition (legacy) — referral quality unknown.
    return {"node_id": node_id_hex, "version": version, "free": dict(free),
            "total": dict(total), "labels": dict(labels),
            "idle_workers": idle_workers, "sched_addr": sched_addr,
            "data_addr": data_addr, "is_head": is_head,
            "store_frac": store_frac, "pool_shapes": pool_shapes}


def pool_shape_key(resources: Dict[str, float]) -> tuple:
    """Canonical pool-shape key for a resource ask — the same sorted
    (name, amount) pairs the daemon keys its warm pool by, normalized so
    int/float spellings of the same ask compare equal across the wire."""
    return tuple(sorted((str(k), float(v)) for k, v in resources.items()))


def has_matching_shape(pool_shapes, resources: Dict[str, float]):
    """Whether a gossiped pool composition holds a warm worker of EXACTLY
    the asked shape (pool-take matches exact shapes, so anything else is
    a dead referral). None = composition unknown (the peer gossips no
    shapes) — callers treat that as 'maybe'."""
    if pool_shapes is None:
        return None
    ask = pool_shape_key(dict(resources))
    for row in pool_shapes:
        try:
            shape, count = row[0], row[1]
        except (TypeError, IndexError, KeyError):
            continue
        if count and tuple(
                (str(k), float(v)) for k, v in shape) == ask:
            return True
    return False


class ClusterView:
    """Compacted per-node view entries + a view-level version.

    `update` ignores regressions of a node's own version (a reconnecting
    daemon's stale delta must not rewind the view); every accepted change
    bumps the view version so consumers can detect staleness cheaply."""

    def __init__(self):
        self.entries: Dict[str, dict] = {}   # node_id hex -> entry
        self.version = 0
        # epoch fencing: the cluster epoch stamped into head-built
        # snapshots (0 until the first adopt); consumers tag lease/pool
        # traffic with it so stale-epoch ops are rejected after a head
        # restart instead of silently mutating the rebuilt ledger
        self.epoch = 0
        # flight-recorder gossip health: when this consumer last adopted a
        # head-pushed snapshot (monotonic; 0 = never) — `staleness_s()` is
        # the age of the cached view, gossiped back to the head as
        # per-node `gossip_lag_s`
        self.adopted_ts: float = 0.0
        # serve-replica live-load rows piggybacked on head snapshots
        # (changed-only, so absence in a snapshot means "unchanged");
        # None until the first row batch arrives — consumers
        # (serve/live_signals.py) distinguish "no serve plane yet" from
        # "idle serve plane" and fall back to the state API for the former
        self.serve_loads: Optional[list] = None
        # interest-scoped view plane: when the head shards its broadcast,
        # a scoped subscriber holds full entries only for its interest
        # shards (versioned independently, so a stale shard payload can
        # never rewind another shard's entries) plus a compact digest of
        # the whole cluster for spillback candidate selection
        self.nshards = 0
        self.shard_vs: Dict[int, int] = {}
        self.digest: Optional[dict] = None

    def staleness_s(self) -> float:
        """Seconds since the last adopted snapshot; -1 = never adopted."""
        import time

        if not self.adopted_ts:
            return -1.0
        return time.monotonic() - self.adopted_ts

    def update(self, entry: dict) -> bool:
        cur = self.entries.get(entry["node_id"])
        if cur is not None and entry["version"] < cur["version"]:
            return False
        if cur == entry:
            return False
        self.entries[entry["node_id"]] = entry
        self.version += 1
        return True

    def remove(self, node_id_hex: str) -> bool:
        if self.entries.pop(node_id_hex, None) is None:
            return False
        self.version += 1
        return True

    def snapshot(self) -> dict:
        return {"version": self.version,
                "nodes": list(self.entries.values())}

    def adopt(self, snap: dict) -> None:
        """Replace wholesale with a pushed snapshot. Pushes ride one FIFO
        connection, so the latest received is the latest sent; the version
        is kept for diagnostics and conflict reporting."""
        import time

        self.entries = {e["node_id"]: e for e in snap.get("nodes", [])}
        self.version = snap.get("version", self.version)
        self.epoch = snap.get("epoch", self.epoch)
        # a wholesale snapshot supersedes any sharded history (e.g. the
        # head restarted with sharding off)
        self.nshards = 0
        self.shard_vs.clear()
        wl = snap.get("workloads")
        if wl is not None:
            self.serve_loads = wl
        self.adopted_ts = time.monotonic()

    def adopt_shards(self, snap: dict) -> None:
        """Apply a sharded, interest-scoped broadcast payload.

        Each shard blob is a SNAPSHOT of that shard's current entries at
        an independent per-shard version: a blob at or below the version
        already applied for ITS shard is dropped (a delayed or replayed
        push must never rewind one shard while another is current), and
        applying a blob replaces that shard's entries wholesale so node
        removals need no tombstones. An epoch change (head restart) or a
        reshard invalidates EVERY cached shard atomically — entries from
        the old epoch's shards must not survive into the new one."""
        import time

        epoch = snap.get("epoch", 0)
        nshards = snap.get("nshards", 0)
        if ((epoch and self.epoch and epoch != self.epoch)
                or (self.nshards and nshards != self.nshards)):
            self.entries.clear()
            self.shard_vs.clear()
            self.version += 1
        if nshards:
            self.nshards = nshards
        if epoch:
            self.epoch = epoch
        for blob in snap.get("shards") or ():
            sid, v = blob["sid"], blob["v"]
            if v <= self.shard_vs.get(sid, -1):
                continue  # stale shard payload: keep the newer entries
            for h in [h for h in self.entries
                      if shard_of(h, self.nshards) == sid]:
                del self.entries[h]
            for e in blob.get("nodes") or ():
                self.entries[e["node_id"]] = e
            self.shard_vs[sid] = v
            self.version += 1
        d = snap.get("digest")
        if d is not None:
            self.digest = d
        wl = snap.get("workloads")
        if wl is not None:
            self.serve_loads = wl
        self.adopted_ts = time.monotonic()

    def data_addr_of(self, node_id_hex: str):
        """Cached data-server address of a node, or None — the gossiped
        object directory's companion lookup (zero head RPCs)."""
        e = self.entries.get(node_id_hex)
        addr = e.get("data_addr") if e else None
        return tuple(addr) if addr else None

    def max_store_frac(self) -> float:
        """Highest gossiped object-store pressure (used/capacity) across
        the cached view entries; 0.0 when no node reports one. The data
        plane's zero-RPC backpressure signal: a producer consults this
        before admitting more blocks into the cluster."""
        frac = 0.0
        for e in self.entries.values():
            f = e.get("store_frac")
            if f is not None and f > frac:
                frac = f
        return frac

    # ------------------------------------------------------------ routing
    def select_node(self, resources: Dict[str, float],
                    label_selector: Optional[dict] = None,
                    require_sched: bool = True,
                    exclude: Optional[str] = None) -> Optional[dict]:
        """Feasible-node selection against the cached view: a node whose
        labels match and that either has warm idle pool workers or free
        capacity for the ask. Prefers the warmest pool (most idle
        workers), breaking ties on free capacity — the reference's
        best-node-by-load flavor without a second RPC."""
        best, best_key = None, None
        for e in self.entries.values():
            if require_sched and not e.get("sched_addr"):
                continue
            if exclude is not None and e["node_id"] == exclude:
                continue
            if not matches_labels(e.get("labels") or {}, label_selector):
                continue
            warm = e.get("idle_workers", 0)
            if not warm and not fits(e.get("free") or {}, resources):
                continue
            if not fits(e.get("total") or {}, resources):
                continue
            key = (warm, sum((e.get("free") or {}).values()))
            if best_key is None or key > best_key:
                best, best_key = e, key
        return best

    def spill_candidates(self, resources: Dict[str, float],
                         label_selector: Optional[dict] = None,
                         exclude: Optional[str] = None,
                         limit: int = 2) -> List[dict]:
        """Peer daemons a local-pool miss can spill to: nodes whose
        gossiped pools show warm idle workers, warmest first. Full view
        entries are checked against totals; digest candidate rows (nodes
        outside this consumer's interest shards) carry no totals, so only
        labels gate them — the peer's own pool-take decides the rest.

        Referral quality: peers that gossip pool composition
        (`pool_shapes`) and provably hold NO warm worker of the asked
        shape are dropped — pool-take matches exact shapes, so referring
        to them is a guaranteed cold refusal hop. Peers whose composition
        shows a match rank above peers that don't gossip shapes."""
        if limit <= 0:
            return []
        # full entries are authoritative where we hold them: a digest row
        # must never resurrect a node the entry disqualified
        seen = set(self.entries)
        rows = []

        def _consider(e, check_total: bool):
            if (not e.get("sched_addr") or not e.get("idle_workers")
                    or e["node_id"] == exclude):
                return
            if not matches_labels(e.get("labels") or {}, label_selector):
                return
            if check_total and not fits(e.get("total") or {}, resources):
                return
            match = has_matching_shape(e.get("pool_shapes"), resources)
            if match is False:
                return  # dead referral: warm pool holds no such shape
            rows.append({"node_id": e["node_id"],
                         "sched_addr": tuple(e["sched_addr"]),
                         "idle_workers": e.get("idle_workers", 0),
                         "shape_match": match})

        for e in self.entries.values():
            _consider(e, check_total=True)
        for d in (self.digest or {}).get("candidates") or ():
            if d["node_id"] not in seen:
                _consider(d, check_total=False)
        rows.sort(key=lambda r: (bool(r["shape_match"]),
                                 r["idle_workers"]), reverse=True)
        return rows[:limit]
