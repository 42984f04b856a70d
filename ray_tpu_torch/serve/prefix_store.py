"""Cluster prefix store keys (counterpart of `ray_tpu/serve/prefix_store.py`).

Only the KV-compatibility key is ported so far; the store itself rides the
object plane, which the port does not have yet.
"""

from __future__ import annotations


def model_cache_key(weights_id: str, n_layer: int, n_head: int,
                    head_dim: int, dtype, block_size: int) -> str:
    """KV-compatibility key: two engines share prefix entries iff their
    keys match (same weights, same cache geometry). LoRA engines pass the
    BASE model's weights_id so adapters share base-model prefixes. The same
    string as the JAX package's for the same engine."""
    return (f"{weights_id}|L{n_layer}H{n_head}D{head_dim}"
            f"|{dtype}|bs{block_size}")
