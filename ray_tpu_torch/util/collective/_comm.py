"""One collective call on one torch process group, by group-local rank.

A `Comm` wraps either a group that `torch.distributed` registered (a
`DeviceMesh` dimension's) or one this package made on its own store
(`dist_group`), and calls the group's own methods, which both kinds have.

- `nccl` takes CUDA tensors only and never moves data through the host;
  a CPU tensor raises.
- `gloo` takes CUDA tensors in its collectives (allreduce, reduce-scatter,
  all-gather and broadcast accept them on the card) but its send and recv
  abort the process on one, so `send`, `recv` and `exchange` move a CUDA
  tensor through the host by design (the JAX package's `kv` backend does
  the same). `HOST_STAGED` counts the bytes they copy, so a caller can see
  that an NCCL path copied none.
- `exchange` (one ring hop: send to one peer while receiving from another)
  groups its two operations as `torch.distributed.batch_isend_irecv` does:
  under NCCL inside one coalesced group, since a send and a recv with the
  same peer share one stream and would otherwise wait on each other.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.types import ReduceOp

# bytes that gloo calls copied between a CUDA tensor and the host
HOST_STAGED: collections.Counter = collections.Counter()

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class Comm:
    pg: Any          # a torch ProcessGroup or Backend
    backend: str     # "nccl" or "gloo"

    @classmethod
    def registered(cls, pg) -> "Comm":
        """A group torch.distributed registered (new_group, DeviceMesh)."""
        return cls(pg, str(dist.get_backend(pg)))

    @property
    def rank(self) -> int:
        return self.pg.rank()

    @property
    def size(self) -> int:
        return self.pg.size()

    # ------------------------------------------------------------- staging
    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError(
                f"the nccl backend takes CUDA tensors, got one on "
                f"{t.device}; use a gloo group for CPU tensors")
        return t

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a point-to-point call is handed: a host copy of a CUDA
        tensor under gloo."""
        self._check(t)
        if self.backend == "gloo" and t.is_cuda:
            HOST_STAGED["bytes"] += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, dst: torch.Tensor, staged: torch.Tensor) -> None:
        if staged is not dst:
            HOST_STAGED["bytes"] += staged.numel() * staged.element_size()
            dst.copy_(staged)

    # ----------------------------------------------------------------- ops
    def all_reduce(self, t: torch.Tensor, op: ReduceOp = ReduceOp.SUM):
        """In place. SUM, MAX or MIN (PRODUCT: `hierarchy.gathered_reduce`)."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = _TORCH_OPS[op]
        self.pg.allreduce([self._check(t)], opts).wait()
        return t

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        """SUM of `inp` ([size * n]) over the group; rank r gets slice r."""
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self.pg._reduce_scatter_base(self._check(out), self._check(inp),
                                     opts).wait()
        return out

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        """`out` ([size * n]) gets every rank's `inp` ([n]) in rank order."""
        self.pg._allgather_base(self._check(out), self._check(inp)).wait()
        return out

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor):
        """`inp` ([size, ...]): row j goes to rank j; `out` (the same
        shape) gets rank i's row in row i."""
        self.pg.alltoall_base(self._check(out), self._check(inp), [], [],
                              dist.AllToAllOptions()).wait()
        return out

    def broadcast(self, t: torch.Tensor, root: int):
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = root, 0
        self.pg.broadcast([self._check(t)], opts).wait()
        return t

    def send(self, t: torch.Tensor, dst: int) -> None:
        self.pg.send([self._host(t).contiguous()], dst, 0).wait()

    def recv(self, t: torch.Tensor, src: int):
        h = self._host(t)
        self.pg.recv([h], src, 0).wait()
        self._back(t, h)
        return t

    def exchange(self, out: torch.Tensor, dst: int, inp: torch.Tensor,
                 src: int) -> torch.Tensor:
        """Send `out` to `dst` while receiving `inp` from `src` (one ring
        hop). Under NCCL both run in one coalesced group (ncclGroupStart/
        End); under gloo both are posted before either is waited on."""
        h_out, h_in = self._host(out).contiguous(), self._host(inp)
        if self.backend == "nccl":
            self.pg._start_coalescing(out.device)
            self.pg.send([h_out], dst, 0)
            self.pg.recv([h_in], src, 0)
            works = [self.pg._end_coalescing(out.device)]
        else:
            works = [self.pg.send([h_out], dst, 0),
                     self.pg.recv([h_in], src, 0)]
        for w in works:
            w.wait()
        self._back(inp, h_in)
        return inp

    def barrier(self) -> None:
        self.pg.barrier().wait()
