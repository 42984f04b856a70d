"""Paged KV-cache block pool with prompt-prefix reuse (counterpart of
`ray_tpu/serve/kv_cache.py`).

KV state is pooled in fixed-size token blocks addressed by a rolling content
hash of the prompt prefix, so requests sharing a prefix skip prefill for the
cached span and shared prefixes are stored once. The pool is a device tensor
``[n_layer, n_blocks, n_head, block_size, head_dim]``; reuse copies whole
blocks between it and the engine's dense per-slot cache, in place. A
tensor-parallel engine's pool is one such tensor a device, holding that
device's heads, and every copy runs on each; its blobs hold every head, as
a one-device engine's do, so the two exchange them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch


def _chain_hash(prev: bytes, token_block: Tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(repr(token_block).encode())
    return h.digest()


def chain_hashes(ids: List[int], block_size: int) -> List[Tuple[bytes, int]]:
    """Rolling content hashes of every FULL block boundary of a prompt:
    [(hash_of_blocks_1..k, k*block_size), ...]. Byte-identical to the JAX
    package's, so a prefix key computed by either package matches the other's.
    """
    out: List[Tuple[bytes, int]] = []
    h = b"root"
    for i in range(0, len(ids) - len(ids) % block_size, block_size):
        h = _chain_hash(h, tuple(ids[i:i + block_size]))
        out.append((h, i + block_size))
    return out


class PagedKVCache:
    """Host-side block table + device-side block pool.

    match_prefix(ids)  -> (n_cached_tokens, [block ids]) — longest chain
                          of full blocks whose content hashes are pooled.
    store_prefix(...)  -> copy a finished prompt's full blocks from a
                          slot's dense cache into the pool (dedup'd).
    copy_into_slot(...)-> materialize matched blocks into a slot cache.
    """

    def __init__(self, n_layer: int, n_head: int, head_dim: int,
                 num_blocks: int = 64, block_size: int = 16,
                 dtype=torch.float32, device=None, devices=None):
        """`devices`: a tensor-parallel engine's, the heads split evenly
        over them in order (`device` for one)."""
        from ray_tpu_torch.utils.platform import default_device

        self.block_size = block_size
        self.num_blocks = num_blocks
        devices = [default_device(d) for d in (devices or [device])]
        shape = (n_layer, num_blocks, n_head // len(devices), block_size,
                 head_dim)
        # (pool_k, pool_v) a device; pool_k, pool_v are the first's
        self.pools = [(torch.zeros(shape, dtype=dtype, device=d),
                       torch.zeros(shape, dtype=dtype, device=d))
                      for d in devices]
        self.pool_k, self.pool_v = self.pools[0]
        self._free: List[int] = list(range(num_blocks))
        # chain hash -> block id, LRU order (least recent first)
        self._table: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.blocks_evicted = 0

    def _span(self, cache_t: torch.Tensor, t0: int) -> slice:
        # the JAX copies clamp the window start inside the cache
        t0 = min(t0, cache_t.shape[3] - self.block_size)
        return slice(t0, t0 + self.block_size)

    # ------------------------------------------------------------ hashing
    def _chains(self, ids: List[int]):
        """(chain_hash, token_block) for every FULL block of ids."""
        B = self.block_size
        for h, n in chain_hashes(ids, B):
            yield h, tuple(ids[n - B:n])

    # ------------------------------------------------------------- lookup
    def recent_chain_hashes(self, n: int = 48) -> List[bytes]:
        """The most-recently-touched pooled chain hashes (LRU tail): what
        an engine advertises as its resident-prefix routing hint."""
        return list(self._table)[-n:]

    def peek_prefix_len(self, ids: List[int]) -> int:
        """Cached-token count for `ids`' prefix without touching the LRU
        order or the hit/miss counters."""
        n = 0
        for h, _blk in self._chains(ids):
            if h not in self._table:
                break
            n += self.block_size
        return n

    def match_prefix(self, ids: List[int]) -> Tuple[int, List[int]]:
        blocks: List[int] = []
        for h, _blk in self._chains(ids):
            blk_id = self._table.get(h)
            if blk_id is None:
                break
            self._table.move_to_end(h)       # LRU touch
            blocks.append(blk_id)
        n = len(blocks) * self.block_size
        if blocks:
            self.hits += 1
            self.tokens_reused += n
        else:
            self.misses += 1
        return n, blocks

    # ----------------------------------------------------------- eviction
    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if not self._table:
            return None
        # evict the least-recently-matched chain entry; a child whose parent
        # is evicted can never match again and ages out the same way
        _h, blk = self._table.popitem(last=False)
        self.blocks_evicted += 1
        return blk

    # -------------------------------------------------------------- store
    def _shards(self, cache) -> list:
        """((pool_k, pool_v), cache) a device: `cache` is the engine's
        {"k","v"}, or a tensor-parallel engine's list of them."""
        return list(zip(self.pools, cache if isinstance(cache, list)
                        else [cache]))

    def store_prefix(self, ids: List[int], cache, slot: int) -> int:
        """Copy every full block of `ids` from `cache`'s dense slot lane into
        the pool (skipping chains already present). Returns the number of new
        blocks stored. `cache` is the engine's {"k","v"} (a list of them a
        device under tensor parallelism)."""
        stored = 0
        t0 = 0
        for h, _blk in self._chains(ids):
            if h not in self._table:
                blk = self._alloc()
                if blk is None:
                    break
                for (pool_k, pool_v), c in self._shards(cache):
                    span = self._span(c["k"], t0)
                    pool_k[:, blk] = c["k"][:, slot, :, span]
                    pool_v[:, blk] = c["v"][:, slot, :, span]
                self._table[h] = blk
                stored += 1
            else:
                self._table.move_to_end(h)
            t0 += self.block_size
        return stored

    # --------------------------------------------------------------- load
    def copy_into_slot(self, cache, slot: int, blocks: List[int]):
        """Write matched pool blocks into the cache's slot lane from position
        0, in place; returns the cache dict."""
        t0 = 0
        for blk in blocks:
            for (pool_k, pool_v), c in self._shards(cache):
                span = self._span(c["k"], t0)
                c["k"][:, slot, :, span] = pool_k[:, blk]
                c["v"][:, slot, :, span] = pool_v[:, blk]
            t0 += self.block_size
        return cache

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"blocks_total": self.num_blocks,
                "blocks_used": self.num_blocks - len(self._free),
                "block_size": self.block_size,
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "tokens_reused": self.tokens_reused,
                "blocks_evicted": self.blocks_evicted}


# ----------------------------------------------------- KV transfer (P/D)
# Blob schema shared with the JAX package: {"ids", "k", "v", "block_size"}
# with k/v numpy [n_blocks, L, H, Bs, Dh].

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: a bf16 pool exports as float32, which is exact
    # and which the JAX import casts back to its pool dtype
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # the JAX package's bf16 blobs (ml_dtypes) hold the same 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def export_prefix(kv: PagedKVCache, ids) -> Optional[dict]:
    """Serialize the pooled KV blocks covering `ids`' prefix into a host blob.
    Returns None when nothing is pooled for this prompt."""
    n, blocks = kv.match_prefix(list(ids))
    if not blocks:
        return None
    def whole(pools):     # every device's heads, in order
        return torch.cat([p[:, torch.tensor(blocks, device=p.device)].cpu()
                          for p in pools], dim=2)
    k = _to_numpy(whole([k for k, _ in kv.pools]).transpose(0, 1))
    v = _to_numpy(whole([v for _, v in kv.pools]).transpose(0, 1))
    return {"ids": list(ids[:n]), "k": k, "v": v,
            "block_size": kv.block_size}


def import_prefix(kv: PagedKVCache, blob: dict) -> int:
    """Install an exported prefix into this pool (dedup'd against what is
    already cached). Returns the number of new blocks installed."""
    if not blob:
        return 0
    if blob["block_size"] != kv.block_size:
        raise ValueError(
            f"block_size mismatch: {blob['block_size']} != {kv.block_size}")
    installed = 0
    for i, (h, _blk) in enumerate(kv._chains(blob["ids"])):
        if h in kv._table:
            kv._table.move_to_end(h)
            continue
        blk = kv._alloc()
        if blk is None:
            break
        n = len(kv.pools)
        for (pool_k, pool_v), k, v in zip(
                kv.pools, _from_numpy(blob["k"][i]).chunk(n, dim=1),
                _from_numpy(blob["v"][i]).chunk(n, dim=1)):
            pool_k[:, blk] = k.to(pool_k)
            pool_v[:, blk] = v.to(pool_v)
        kv._table[h] = blk
        installed += 1
    return installed
