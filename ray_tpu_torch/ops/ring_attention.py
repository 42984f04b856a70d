"""Sequence/context parallelism: ring attention and Ulysses over an `sp`
mesh axis (counterpart of `ray_tpu/ops/ring_attention.py`).

- **Ring attention.** Q stays put; K/V chunks rotate round the `sp` group
  one hop a step (`Comm.exchange`, a grouped send/recv, along
  `hierarchy.ring_perm`). On rank i of sp, with chunks of n positions, the
  forward runs K1 (`flash_attention_fwd`) on the chunk pair (i, i) with the
  causal mask and on every pair (i, j < i) without it; pairs j > i are
  fully masked, contribute zero, and are skipped. The pairs' (out, lse)
  merge in f32 by log-sum-exp, which gives the JAX ring's online-softmax
  result. The backward runs K2 and K3 on each live pair with the GLOBAL
  out and lse (and K2's Delta): dQ accumulates on the rank, and the dK/dV
  accumulators travel round the ring with K/V, back to their owner after
  sp hops. A CUDA tensor launches the kernels or raises; a CPU tensor runs
  their plain versions, through the same schedule.
- **Ulysses.** A tiled all-to-all turns [heads sharded, seq local] into
  [heads local-subset, seq whole], dense attention (`mha_reference`) runs
  on each rank's heads, and an all-to-all turns it back; the all-to-all's
  backward is the inverse all-to-all. Needs H % sp == 0.

Each rank's ring schedule is a generator (`ring_forward`,
`ring_backward`) that yields the tensors it passes to the next rank and
receives the previous rank's: `drive` runs one with an exchange (the
distributed path's `Comm.exchange`), `drive_virtual` runs sp of them in one
process with an in-process rotation (one card standing in for a ring).
The ring takes any head dim up to 256 (the flash wrappers pad it to the
kernels' widths) and any chunk length: a chunk longer than a block that
does not divide into blocks of 128 is zero-padded at its end to the next
multiple, K1 and K2 mask the padded keys on the non-causal pairs with
their `kv_len` bound (on the causal diagonal, causality already hides them
from the real queries), and the padded rows are dropped. Past Dh = 256 it
raises `ValueError`. The accounted wire bytes are the JAX package's, of
the unpadded chunks.

`ring_attention` and `ulysses_attention` take DTensors sharded
("batch", "heads", "seq", None) and run the local functions through
`local_map`; with no mesh, or sp == 1, they are `mha_reference`, the JAX
package's rule.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from ray_tpu_torch.ops.flash_attention import (
    DEFAULT_BLOCK_Q, HEAD_DIMS, NEG_INF, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd, map_local_shards,
    mha_reference, on_local_shards)
from ray_tpu_torch.util.collective.hierarchy import (account_collective,
                                                     ring_perm)


# ---------------------------------------------------------------------------
# Chunk accumulation: the JAX ring's step, plain torch (the reference the
# kernel schedule is held against)
# ---------------------------------------------------------------------------

def _chunk_update(q, kc, vc, m, l, acc, scale, q_off, k_off, causal):
    """Merge one K/V chunk into the online-softmax state.

    q [B,H,Tq,D]; kc,vc [B,H,Tk,D]; m,l [B,H,Tq,1]; acc [B,H,Tq,D] (f32).
    q_off/k_off are the global positions of element 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    mask = None
    if causal:
        Tq, Tk = q.shape[2], kc.shape[2]
        q_pos = q_off + torch.arange(Tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(Tk, device=q.device)[None, :]
        mask = q_pos >= k_pos
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    if mask is not None:
        # a fully-masked chunk must contribute zero (finite NEG_INF
        # arithmetic would otherwise give p=1 while m is at its start)
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vc.float())
    return m_new, l_new, acc_new


# ---------------------------------------------------------------------------
# The ring: one rank's schedule, and what drives it
# ---------------------------------------------------------------------------

def check_ring_shape(t_local: int, head_dim: int) -> None:
    """The kernels' shape contract on a chunk of `t_local` positions: any
    length (`_padded_len`), head dims up to 256."""
    if head_dim > HEAD_DIMS[-1]:
        raise ValueError(f"ring attention runs the flash kernels: head dim "
                         f"{head_dim} > {HEAD_DIMS[-1]}, the widest they "
                         f"are built for")


def _padded_len(n: int) -> int:
    """A chunk of n positions padded to the flash kernels' block contract:
    n itself up to a block, else the next multiple of the block."""
    block = DEFAULT_BLOCK_Q
    return n if n <= block else -(-n // block) * block


def _pad_seq(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    """t [B, H, n, ...] zero-padded at the end of dim 2 to n_pad rows."""
    n = t.shape[2]
    if n == n_pad:
        return t
    pad = [0, 0] * (t.dim() - 3) + [0, n_pad - n]
    return torch.nn.functional.pad(t, pad)


def _pad_chunk(*ts) -> tuple:
    """One chunk's tensors [B, H, n, ...] padded to `_padded_len(n)`, and
    the kv_len bound of its padded keys (None where nothing is padded)."""
    n = ts[0].shape[2]
    n_pad = _padded_len(n)
    return n if n_pad > n else None, [_pad_seq(t, n_pad) for t in ts]


def _pair(rank: int, src: int, causal: bool):
    """(live, causal mask) of the chunk pair (rank's Q, src's K/V)."""
    if not causal:
        return True, False
    return src <= rank, src == rank


def _merge(acc, lse, out, lse_i):
    """Merge one pair's (out, lse) into the running f32 (acc, lse)."""
    if acc is None:
        return out.float(), lse_i
    new = torch.logaddexp(lse, lse_i)
    acc = (acc * torch.exp(lse - new)[..., None]
           + out.float() * torch.exp(lse_i - new)[..., None])
    return acc, new


def ring_forward(q, k, v, rank: int, sp: int, causal: bool, scale: float):
    """Rank `rank`'s forward (a generator): yields [k, v] it passes on and
    receives the previous rank's, sp - 1 times; returns (out in q's dtype,
    lse [B, H, n] f32), q, k, v being this rank's chunks [B, H, n, Dh].
    A ragged chunk travels padded (`_padded_len`), its padded keys masked
    by `kv_len` on the non-causal pairs."""
    n = q.shape[2]
    kv_len, (q, k, v) = _pad_chunk(q, k, v)
    acc = lse = None
    k_cur, v_cur = k, v
    for step in range(sp):
        src = (rank - step) % sp
        live, mask = _pair(rank, src, causal)
        if live:
            o, l = flash_attention_fwd(q, k_cur, v_cur, mask, scale,
                                       kv_len=None if mask else kv_len)
            acc, lse = _merge(acc, lse, o, l)
        if step != sp - 1:
            k_cur, v_cur = yield [k_cur, v_cur]
    return acc[:, :, :n].to(q.dtype), lse[:, :, :n]


def ring_backward(q, k, v, out, lse, do, rank: int, sp: int, causal: bool,
                  scale: float):
    """Rank `rank`'s backward (a generator): K2 and K3 on each live pair
    with the global out and lse. Yields [k, v, dk, dv] sp - 1 times and
    [dk, dv] once more (the accumulators' last hop home); returns (dq, dk,
    dv) in the inputs' dtypes. A ragged chunk is padded as in
    `ring_forward`: its padded rows carry dO = 0 (so K3 needs no mask) and
    their gradients are dropped."""
    n = q.shape[2]
    kv_len, (q, k, v, out, do, lse) = _pad_chunk(q, k, v, out, do, lse)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for step in range(sp):
        src = (rank - step) % sp
        live, mask = _pair(rank, src, causal)
        if live:
            dq_i, delta = flash_attention_bwd_dq(
                q, k_cur, v_cur, out, lse, do, mask, scale,
                kv_len=None if mask else kv_len)
            dk_i, dv_i = flash_attention_bwd_dkv(q, k_cur, v_cur, do, lse,
                                                 delta, mask, scale)
            dq = dq + dq_i.float()
            dk = dk + dk_i.float()
            dv = dv + dv_i.float()
        if step != sp - 1:
            k_cur, v_cur, dk, dv = yield [k_cur, v_cur, dk, dv]
        else:
            dk, dv = yield [dk, dv]
    return tuple(t[:, :, :n].to(dtype) for t, dtype in
                 ((dq, q.dtype), (dk, k.dtype), (dv, v.dtype)))


def drive(schedule, exchange: Callable[[List[torch.Tensor]], list]):
    """Run one rank's schedule to its end; exchange(tensors) passes them
    to the next rank of the ring and returns the previous rank's."""
    try:
        msg = next(schedule)
        while True:
            msg = schedule.send(exchange(msg))
    except StopIteration as done:
        return done.value


def drive_virtual(schedules: list) -> list:
    """Run the schedules of all sp ranks of a ring in one process, in
    lockstep: each step rank r receives what rank r - 1 yielded. Returns
    their results by rank."""
    n = len(schedules)
    results, sent = [None] * n, [None] * n
    inbox = None
    while True:
        for r, sched in enumerate(schedules):
            try:
                sent[r] = next(sched) if inbox is None else sched.send(
                    inbox[r])
            except StopIteration as done:
                results[r], sent[r] = done.value, None
        if all(m is None for m in sent):
            return results
        if any(m is None for m in sent):
            raise RuntimeError("ring schedules ended at different steps")
        inbox = [sent[(r - 1) % n] for r in range(n)]


def _comm_exchange(comm) -> Callable[[List[torch.Tensor]], list]:
    """One ring hop over the `sp` group's Comm: each tensor to the next
    rank of `ring_perm`, grouped with the receive from the previous one."""
    perm = ring_perm(comm.size)
    dst = perm[comm.rank][1]
    src = next(i for i, j in perm if j == comm.rank)

    def exchange(ts):
        return [comm.exchange(t, dst, torch.empty(t.shape, dtype=t.dtype,
                                                  device=t.device), src)
                for t in ts]
    return exchange


class RingAttention(torch.autograd.Function):
    """Ring attention on one rank's chunks: residuals (q, k, v, out, lse)
    as in `FlashAttention`; forward `ring_forward`, backward
    `ring_backward`, both driven by `exchange`."""

    @staticmethod
    def forward(ctx, q, k, v, exchange, rank, sp, causal, scale):
        out, lse = drive(ring_forward(q, k, v, rank, sp, causal, scale),
                         exchange)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (exchange, rank, sp, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        exchange, rank, sp, causal, scale = ctx.args
        dq, dk, dv = drive(ring_backward(q, k, v, out, lse, do, rank, sp,
                                         causal, scale), exchange)
        return dq, dk, dv, None, None, None, None, None


def ring_attention_local(q, k, v, comm, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention on this rank's shards [B, H, T/sp, Dh], the ring
    being `comm` (the sp group's `Comm`)."""
    check_ring_shape(q.shape[2], q.shape[3])
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return RingAttention.apply(q, k, v, _comm_exchange(comm), comm.rank,
                               comm.size, causal, scale)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, comm, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """A tiled all-to-all over `comm` (`lax.all_to_all(..., tiled=True)`):
    x splits into comm.size chunks along split_axis, chunk j goes to rank
    j, and the chunks received concatenate along concat_axis in rank
    order."""
    inp = torch.stack(x.chunk(comm.size, dim=split_axis)).contiguous()
    out = comm.all_to_all(torch.empty_like(inp), inp)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.args = (comm, split_axis, concat_axis)
        return all_to_all(x, comm, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        comm, split_axis, concat_axis = ctx.args
        return all_to_all(g, comm, concat_axis, split_axis), None, None, None


def ulysses_attention_local(q, k, v, comm, causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses on this rank's shards [B, H, T/sp, Dh]: all-to-all heads <->
    seq over `comm`, dense attention, all-to-all back. Needs H % sp == 0."""
    if q.shape[1] % comm.size:
        raise ValueError(f"Ulysses needs the heads ({q.shape[1]}) to "
                         f"divide by sp ({comm.size})")
    qg, kg, vg = (_AllToAll.apply(t, comm, 1, 2) for t in (q, k, v))
    out = mha_reference(qg, kg, vg, causal=causal, scale=scale)
    return _AllToAll.apply(out, comm, 2, 1)


# ---------------------------------------------------------------------------
# DTensor entry points
# ---------------------------------------------------------------------------

def _on_sp_shards(local_fn, q, k, v, mesh, axis, causal, scale):
    """local_fn on each rank's [B, H, T/sp, Dh] shard: placements that
    split the sequence (dim 2) over `axis` and batch and heads elsewhere.
    Accounts the wire bytes as the JAX package's eager entry does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.util.collective._comm import Comm

    names = tuple(mesh.mesh_dim_names)
    sp = mesh.size(names.index(axis))
    if q.shape[2] % sp:
        raise ValueError(f"{local_fn.__name__}: the sequence ({q.shape[2]}) "
                         f"must divide by sp ({sp})")
    if local_fn is ring_attention_local:
        check_ring_shape(q.shape[2] // sp, q.shape[3])
    if not isinstance(q, DTensor):
        raise TypeError(f"{local_fn.__name__} on a mesh with {axis} > 1 "
                        f"takes DTensors, got {type(q).__name__}")
    placements = tuple(q.placements)
    for name, p in zip(names, placements):
        want_seq = name == axis
        ok = (isinstance(p, Shard) and p.dim % 4 == 2) if want_seq else (
            isinstance(p, Replicate)
            or (isinstance(p, Shard) and p.dim % 4 in (0, 1)))
        if not ok:
            raise ValueError(f"{local_fn.__name__} needs q, k, v sharded "
                             f"(batch, heads, seq on {axis!r}, None), got "
                             f"{placements} over {names}")
    qb, kb, vb = (t.numel() * t.element_size() for t in (q, k, v))
    if local_fn is ring_attention_local:
        # K and V each rotate sp-1 hops around the ring
        op, nbytes = "ring_attention.ppermute", (sp - 1) * (kb + vb)
    else:
        # four tiled all_to_alls (q/k/v in, output back), each moving
        # (sp-1)/sp of its operand off the rank
        op = "ulysses.all_to_all"
        nbytes = (sp - 1) * (2 * qb + kb + vb) // sp
    account_collective(op, nbytes, k.dtype, hop="intra")
    comm = Comm.registered(mesh.get_group(axis))
    return map_local_shards(
        lambda q, k, v: local_fn(q, k, v, comm, causal, scale), q, k, v)


def _dense(q, k, v, causal, scale):
    """mha_reference, on each rank's local shard of DTensors."""
    from torch.distributed.tensor import DTensor

    def fn(q, k, v):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return on_local_shards(fn, q, k, v) if isinstance(q, DTensor) \
        else fn(q, k, v)


def _entry(local_fn, q, k, v, causal, scale, axis, mesh):
    from ray_tpu_torch.parallel.mesh import axis_size, current_mesh

    mesh = mesh or current_mesh()
    if mesh is None or axis_size(mesh, axis) <= 1:
        return _dense(q, k, v, causal, scale)
    return _on_sp_shards(local_fn, q, k, v, mesh, axis, causal, scale)


def ring_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None, axis: str = "sp",
                   mesh=None):
    """Ring attention over the mesh's `sp` axis (`mesh`, or the current
    one): q, k, v [B, H, T, Dh] DTensors sharded ("batch", "heads", "seq",
    None). Dense reference attention with no mesh or sp == 1."""
    return _entry(ring_attention_local, q, k, v, causal, scale, axis, mesh)


def ulysses_attention(q, k, v, causal: bool = True,
                      scale: Optional[float] = None, axis: str = "sp",
                      mesh=None):
    """Ulysses attention over the mesh's `sp` axis (see
    `ring_attention`)."""
    return _entry(ulysses_attention_local, q, k, v, causal, scale, axis,
                  mesh)
