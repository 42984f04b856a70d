"""Cross-process collective group over the head's KV and the shm store.

Counterpart of `ray_tpu/util/collective/kv_group.py` (`backend="kv"`): the
CPU backend that needs nothing but the runtime, the role the reference's
pygloo group plays (`python/ray/util/collective/collective_group/
gloo_collective_group.py:185`, rendezvous through Ray's internal KV). Small
payloads ride the KV store directly; large ones go through the shm object
store and only the ref id rides the KV. CPU tensors and numpy arrays go as
they are; a CUDA tensor is copied to the host and its result written back
(`_to_numpy`, `_write_back`). Reductions run in rank order with numpy, so
the results are bit-equal to the JAX package's group; bf16 (no numpy
dtype) is reduced in f32 and rounded to bf16 after every pairwise op, as
`ml_dtypes`' bfloat16 arithmetic does.

The port's `gloo` backend is torch's gloo (`dist_group`), not an alias of
this group as it is in the JAX package (`types.py`).

Correctness model: every collective is assigned a sequence number per rank
(program order). Rank r posts its contribution under (group, seq, rank) and
polls for its peers'. Garbage collection differs from the JAX package's on
purpose: there each rank deletes its own key of seq n-2 as it starts seq n,
which races with a broadcast, whose source posts and returns without
waiting (allreduce, broadcast(src 1), allgather hangs rank 0 when rank 1
deletes its allreduce key first). Here every rank also keeps a progress
key, the number of ops it has finished, rewritten at the start of each op;
a rank deletes its key of seq s only once every peer's progress is past s.
Point-to-point keys are collected the same way from the receiver's count.
The progress keys themselves stay (one small key a rank); every key is
scoped by the group's incarnation, so a group made again under the same
name never reads a departed one's progress.
"""

from __future__ import annotations

import pickle
import time
from typing import Optional

import numpy as np

from ray_tpu_torch.util.collective.types import ReduceOp

_KV_NS = "collective"
_INLINE_LIMIT = 256 * 1024
_POLL_S = 0.002
# how long destroy() waits for the peers to read this rank's last keys
_DESTROY_WAIT_S = 10.0

_NP_OPS = {ReduceOp.SUM: np.add, ReduceOp.PRODUCT: np.multiply,
           ReduceOp.MIN: np.minimum, ReduceOp.MAX: np.maximum}


class _Bf16:
    """A bf16 payload on the wire: its 2-byte words (numpy has no bf16)."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def __reduce__(self):
        return (_Bf16, (self.bits,))


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to nearest even (NaN kept quiet), the bits of bf16."""
    u = x.astype(np.float32).view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        rounded[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
    return rounded


def _reduce(op: ReduceOp, arrays: list):
    """Rank-order reduction (the JAX package's `_reduce`)."""
    fn = _NP_OPS[op]
    if isinstance(arrays[0], _Bf16):
        out = _bf16_to_f32(arrays[0].bits)
        for a in arrays[1:]:
            out = _bf16_to_f32(_f32_to_bf16(fn(out, _bf16_to_f32(a.bits))))
        return _Bf16(_f32_to_bf16(out))
    out = arrays[0].copy()
    for a in arrays[1:]:
        fn(out, a, out=out)
    return out


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch")


def _to_numpy(tensor):
    """The payload of `tensor`: numpy as it is; a tensor's host copy (one
    device-to-host copy of a CUDA tensor); bf16 as its 2-byte words."""
    if isinstance(tensor, (np.ndarray, _Bf16)):
        return tensor
    if _is_tensor(tensor):
        import torch

        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            return _Bf16(t.cpu().contiguous().view(torch.int16).numpy()
                         .view(np.uint16))
        return t.cpu().numpy()
    return np.asarray(tensor)


def _as_result(like, value):
    """`value` as `like`'s kind: a tensor on `like`'s device when the caller
    passed a tensor, numpy otherwise."""
    if _is_tensor(like):
        import torch

        if isinstance(value, _Bf16):
            t = torch.from_numpy(np.ascontiguousarray(value.bits).view(
                np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
        return t.to(like.device)
    if isinstance(value, _Bf16):
        return value.bits
    return value


def _write_back(tensor, value):
    """In-place update of the caller's tensor or array (the reference's
    collectives mutate their inputs, `collective.py:778-791`); returns it."""
    if isinstance(tensor, np.ndarray):
        tensor[...] = value.bits if isinstance(value, _Bf16) else value
        return tensor
    if _is_tensor(tensor):
        import torch

        with torch.no_grad():
            tensor.copy_(_as_result(tensor, value))
        return tensor
    return value


class KVCollectiveGroup:
    backend_name = "kv"

    def __init__(self, client, group_name: str, world_size: int, rank: int,
                 incarnation: str = "0"):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world {world_size}")
        self._client = client
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._scope = f"{group_name}@{incarnation}"
        self._seq = 0
        self._p2p_seq: dict = {}   # (src, dst) -> seq
        # (tag, seq) -> ObjectRef or None: this rank's posted keys not yet
        # collected (a ref keeps a large payload alive until then)
        self._owned: dict = {}

    # ------------------------------------------------------------- transport
    def _key(self, seq: int, rank: int, tag: str = "c") -> bytes:
        return f"{self._scope}:{tag}:{seq}:{rank}".encode()

    def _progress_key(self, rank: int, tag: str = "c") -> bytes:
        return f"{self._scope}:progress:{tag}:{rank}".encode()

    def _post(self, seq: int, payload, tag: str = "c"):
        blob = pickle.dumps(payload, protocol=5)
        ref = None
        if len(blob) <= _INLINE_LIMIT:
            value = b"I" + blob
        else:
            ref = self._client.put(payload)
            value = b"R" + ref.id.binary()
        self._owned[(tag, seq)] = ref
        self._client.kv_put(_KV_NS, self._key(seq, self.rank, tag), value)

    def _fetch(self, seq: int, rank: int, tag: str = "c",
               timeout: Optional[float] = None):
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        deadline = None if timeout is None else time.monotonic() + timeout
        key = self._key(seq, rank, tag)
        while True:
            value = self._client.kv_get(_KV_NS, key)
            if value is not None:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective {self.group_name} seq {seq}: rank {rank} "
                    f"did not arrive within {timeout}s")
            time.sleep(_POLL_S)
        if value[:1] == b"I":
            return pickle.loads(value[1:])
        return self._client.get([ObjectRef(ObjectID(value[1:]))])[0]

    def _progress(self, rank: int, tag: str = "c") -> int:
        value = self._client.kv_get(_KV_NS, self._progress_key(rank, tag))
        return -1 if value is None else int(value)

    def _delete(self, tag: str, seq: int) -> None:
        ref = self._owned.pop((tag, seq))
        self._client.kv_del(_KV_NS, self._key(seq, self.rank, tag))
        if ref is not None:
            try:
                self._client.free([ref])
            except Exception:
                pass

    def _gc(self) -> None:
        """Delete this rank's collective keys that every peer is past."""
        pending = [s for t, s in self._owned if t == "c"]
        if not pending:
            return
        past = min(self._progress(r) for r in range(self.world_size)
                   if r != self.rank)
        for s in pending:
            if s < past:
                self._delete("c", s)

    def _gc_p2p(self, dst: int) -> None:
        tag = f"p{self.rank}-{dst}"
        pending = [s for t, s in self._owned if t == tag]
        if pending:
            past = self._progress(dst, tag)
            for s in pending:
                if s < past:
                    self._delete(tag, s)

    def _next_seq(self) -> int:
        seq = self._seq
        self._seq += 1
        # "I have finished every op before `seq`": peers may now collect
        # their keys of those ops
        self._client.kv_put(_KV_NS, self._progress_key(self.rank),
                            str(seq).encode())
        self._gc()
        return seq

    def _gather_all(self, tensor, timeout=None) -> list:
        seq = self._next_seq()
        mine = _to_numpy(tensor)
        self._post(seq, mine)
        return [self._fetch(seq, r, timeout=timeout) if r != self.rank
                else mine for r in range(self.world_size)]

    # ------------------------------------------------------------ collectives
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM, timeout=None):
        return _write_back(tensor, _reduce(op, self._gather_all(tensor,
                                                                timeout)))

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM,
               timeout=None):
        parts = self._gather_all(tensor, timeout)
        if self.rank == dst_rank:
            return _write_back(tensor, _reduce(op, parts))
        return tensor

    def broadcast(self, tensor, src_rank: int = 0, timeout=None):
        seq = self._next_seq()
        if self.rank == src_rank:
            self._post(seq, _to_numpy(tensor))
            return tensor
        return _write_back(tensor, self._fetch(seq, src_rank,
                                               timeout=timeout))

    def allgather(self, tensor, timeout=None) -> list:
        """Every rank's tensor in rank order (tensors on the input's device
        for a tensor input, numpy arrays otherwise)."""
        return [_as_result(tensor, p)
                for p in self._gather_all(tensor, timeout)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM,
                      timeout=None):
        """Input shape [world, ...]; returns this rank's reduced slice."""
        arr = _to_numpy(tensor)
        lead = (arr.bits if isinstance(arr, _Bf16) else arr).shape[0]
        if lead != self.world_size:
            raise ValueError(
                f"reducescatter input leading dim {lead} != world "
                f"{self.world_size}")
        parts = self._gather_all(arr, timeout)
        mine = [(_Bf16(p.bits[self.rank]) if isinstance(p, _Bf16)
                 else p[self.rank]) for p in parts]
        return _as_result(tensor, _reduce(op, mine))

    def barrier(self, timeout=None):
        self._gather_all(np.zeros((), np.int8), timeout)

    # ------------------------------------------------------------------- p2p
    def send(self, tensor, dst_rank: int, timeout=None):
        key = (self.rank, dst_rank)
        seq = self._p2p_seq.get(key, 0)
        self._p2p_seq[key] = seq + 1
        self._gc_p2p(dst_rank)
        self._post(seq, _to_numpy(tensor), tag=f"p{self.rank}-{dst_rank}")

    def recv(self, tensor, src_rank: int, timeout=None):
        key = (src_rank, self.rank)
        seq = self._p2p_seq.get(key, 0)
        self._p2p_seq[key] = seq + 1
        tag = f"p{src_rank}-{self.rank}"
        value = self._fetch(seq, src_rank, tag=tag, timeout=timeout)
        # "I have read every message before seq + 1 from src_rank"
        self._client.kv_put(_KV_NS, self._progress_key(self.rank, tag),
                            str(seq + 1).encode())
        return _write_back(tensor, value)

    def destroy(self):
        """Publish that this rank is past every op, then collect its keys as
        the peers get past them (waiting at most `_DESTROY_WAIT_S`; a key a
        peer never reads, because it died, is deleted anyway)."""
        self._client.kv_put(_KV_NS, self._progress_key(self.rank),
                            str(self._seq).encode())
        deadline = time.monotonic() + _DESTROY_WAIT_S
        while self._owned and time.monotonic() < deadline:
            self._gc()
            for dst in {d for (s, d) in self._p2p_seq if s == self.rank}:
                self._gc_p2p(dst)
            if self._owned:
                time.sleep(0.01)
        for tag, seq in list(self._owned):
            self._delete(tag, seq)
