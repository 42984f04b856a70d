"""Collective types: ReduceOp and the backend names.

Counterpart of `ray_tpu/util/collective/types.py`. The JAX package's device
backend is `xla` (XLA collectives over ICI) and its CPU backend `kv` (the
head's KV store). Here the device backend is `nccl` and the CPU backend
`gloo`, both through `torch.distributed`; the JAX spellings map onto them,
so reference code keeps working. A name is only parsed here: `nccl` on a
host without CUDA raises when a group is made (`dist_group`), and never
turns into gloo.
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
    GLOO = "gloo"    # CPU collectives; kv/torch_gloo/cpu map here
    MPI = "mpi"      # rejected, as in the JAX package

    def __new__(cls, name: Union[str, "Backend"] = "nccl"):
        backend = str(name).lower()
        if backend in ("nccl", "xla", "ici", "tpu", "xla-multihost",
                       "xla_multihost", "xmh", "multihost"):
            return Backend.NCCL
        if backend in ("gloo", "kv", "torch_gloo", "cpu"):
            return Backend.GLOO
        if backend == "mpi":
            raise ValueError("MPI is not supported")
        raise ValueError(f"unknown collective backend: {name!r}")

