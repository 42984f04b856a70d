"""Collective types: ReduceOp and the backend names.

Counterpart of `ray_tpu/util/collective/types.py`. The JAX package's device
backend is `xla` (XLA collectives over ICI) and its CPU backend `kv` (the
head's KV store). Here the device backend is `nccl` and the CPU backend
`gloo`, both through `torch.distributed`; the JAX device spellings map onto
`nccl`. `kv` is the JAX package's KV group (`kv_group.py`), carried by the
runtime's head; `gloo` is torch's gloo, not an alias of `kv` as it is in
the JAX package. A name is only parsed here: `nccl` on a host without CUDA
raises when a group is made (`dist_group`), and never turns into gloo.
"""

from __future__ import annotations

import enum
from typing import Union


class ReduceOp(enum.Enum):
    """SUM, MAX and MIN run as the backend's allreduce. PRODUCT runs as a
    chunked all-gather and a product in rank order
    (`hierarchy.gathered_reduce`), as in the JAX package, so every member
    gets the same bits."""

    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class Backend:
    """Backend name validation (the JAX package's `Backend`)."""

    NCCL = "nccl"    # device collectives; xla/ici/tpu/xla-multihost map here
    GLOO = "gloo"    # CPU collectives; torch_gloo/cpu map here
    KV = "kv"        # the head's KV + shm store (kv_group.py)
    MPI = "mpi"      # rejected, as in the JAX package

    def __new__(cls, name: Union[str, "Backend"] = "nccl"):
        backend = str(name).lower()
        if backend in ("nccl", "xla", "ici", "tpu", "xla-multihost",
                       "xla_multihost", "xmh", "multihost"):
            return Backend.NCCL
        if backend in ("gloo", "torch_gloo", "cpu"):
            return Backend.GLOO
        if backend == "kv":
            return Backend.KV
        if backend == "mpi":
            raise ValueError("MPI is not supported")
        raise ValueError(f"unknown collective backend: {name!r}")

