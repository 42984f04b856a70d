"""In-process device collective group: one tensor per local device.

Counterpart of `ray_tpu/util/collective/xla_group.py` (`XlaCollectiveGroup`,
one process driving N chips through `shard_map` programs). Here one process
drives N local devices by copying between them: every reduce gathers the
contributions onto each device and folds them in device order, so every
device holds the same bits. Training across processes uses `dist_group` or a
`DeviceMesh` instead; this group is the eager multi-device API (the
reference's `allreduce_multigpu` shape).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ray_tpu_torch.util.collective.types import ReduceOp

_FOLD = {ReduceOp.SUM: torch.add, ReduceOp.PRODUCT: torch.mul,
         ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum}


class LocalCollectiveGroup:
    def __init__(self, devices: Optional[Sequence] = None,
                 group_name: str = "default"):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass devices=[...] to build a group "
                    "over CPU devices deliberately")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self.group_name = group_name
        self.world_size = len(self.devices)

    def _check(self, tensors: Sequence) -> List[torch.Tensor]:
        if len(tensors) != self.world_size:
            raise ValueError(
                f"need {self.world_size} tensors (one per device), got "
                f"{len(tensors)}")
        return [torch.as_tensor(t) for t in tensors]

    def _fold_onto(self, tensors, device, op: ReduceOp) -> torch.Tensor:
        acc = tensors[0].to(device, copy=True)
        for t in tensors[1:]:
            acc = _FOLD[op](acc, t.to(device))
        return acc

    # ------------------------------------------------------------ collectives
    def allreduce(self, tensors: Sequence, op: ReduceOp = ReduceOp.SUM):
        tensors = self._check(tensors)
        return [self._fold_onto(tensors, d, op) for d in self.devices]

    def reduce(self, tensors: Sequence, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        tensors = self._check(tensors)
        return [self._fold_onto(tensors, self.devices[i], op)
                if i == dst_rank else tensors[i]
                for i in range(self.world_size)]

    def broadcast(self, tensors: Sequence, src_rank: int = 0):
        tensors = self._check(tensors)
        return [tensors[src_rank].to(d, copy=True) for d in self.devices]

    def allgather(self, tensors: Sequence) -> List[List[torch.Tensor]]:
        tensors = self._check(tensors)
        return [[t.to(d, copy=True) for t in tensors] for d in self.devices]

    def reducescatter(self, tensors: Sequence, op: ReduceOp = ReduceOp.SUM):
        """Each rank contributes [world, ...]; rank r receives reduced row
        r."""
        tensors = self._check(tensors)
        return [self._fold_onto([t[r] for t in tensors], d, op)
                for r, d in enumerate(self.devices)]

    def barrier(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def send_recv(self, tensors: Sequence, pairs: Sequence[tuple]):
        """ppermute: pairs is a list of (src_rank, dst_rank); a rank that
        receives nothing gets zeros."""
        tensors = self._check(tensors)
        out = [torch.zeros_like(t, device=d)
               for t, d in zip(tensors, self.devices)]
        for src, dst in pairs:
            out[dst] = tensors[src].to(self.devices[dst], copy=True)
        return out

    def destroy(self) -> None:
        pass
