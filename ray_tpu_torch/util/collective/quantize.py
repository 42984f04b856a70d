"""Quantized allreduce building blocks (int8/fp8 with error feedback).

Counterpart of `ray_tpu/util/collective/quantize.py`: the same math, on
torch tensors, over a `_comm.Comm` instead of a mesh axis name.

- per-chunk absmax scales: the vector is viewed as [n_chunks, chunk] and
  each chunk gets its own scale ``amax / qmax`` (1 where amax is 0; as
  XLA compiles it, ``amax * f32(1/qmax)``), so one outlier only degrades
  its own chunk;
- gather-based exchange: each member quantizes its OWN contribution, the
  wire moves the quantized blocks and their scales (an all-gather, or the
  send/recv ring of `ring_allreduce`), and every member dequantizes and
  sums in f32 in SOURCE-RANK order, so the result is bit-identical on every
  member. Never a quantized reduce (int8 accumulation overflows and its
  order differs between members);
- error feedback: the residual ``x + r - dequant(quant(x + r))`` is
  returned beside the result and carried by the caller into the next call.

fp8 goes on the wire as a uint8 view (gloo's all-gather has no fp8 type),
as the JAX package's ring already bit-casts. Stochastic rounding draws from
a `torch.Generator` the caller seeds (the train step seeds it from step and
rank, where the JAX package folds the rank into ``PRNGKey(step)``); its
draws are torch's, so they cannot equal `jax.random`'s.

Wire cost per member on the inter group: (world-1) · wire_bytes(n), as
`dist_group`'s accounting counts it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# wire dtype -> (torch dtype, the largest magnitude used as the scale's
# denominator). int8 stays symmetric at 127 so -128 never appears; fp8 e4m3
# saturates at 448.
_WIRE = {
    "int8": (torch.int8, 127.0),
    "float8_e4m3fn": (torch.float8_e4m3fn, 448.0),
}


def _on_wire(q: torch.Tensor) -> torch.Tensor:
    """q as the bytes the backend moves: int8 as it is, fp8 as uint8."""
    return q if q.dtype == torch.int8 else q.view(torch.uint8)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with ONE rounding, as a fused multiply-add: XLA's
    code generator contracts the JAX package's ``acc + q * s`` and
    ``x - q * s`` into FMAs, so the port rounds as it does. The product of
    two f32s is exact in f64; the sum's f64 rounding error (TwoSum) decides
    a round-to-odd of its last bit, after which the rounding to f32 is the
    correct rounding of the exact value."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    t = p + c
    bp = t - p
    err = (p - (t - bp)) + (c - bp)
    bits = t.view(torch.int64)
    odd = torch.where((err != 0) & ((bits & 1) == 0),
                      bits + torch.where(err * t > 0, 1, -1), bits)
    return odd.view(torch.float64).to(torch.float32)


def _dequantize_sum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q [world, nc, chunk] and scale [world, nc, 1] dequantized and summed
    in SOURCE-RANK order, acc = fma(q_i, s_i, acc): one order on every
    member, whatever the backend."""
    acc = q[0].to(torch.float32) * scale[0]
    for qi, si in zip(q[1:], scale[1:]):
        acc = _fma(qi.to(torch.float32), si, acc)
    return acc


@dataclasses.dataclass(frozen=True)
class QuantizedAllreduce:
    """Opt-in config for quantizing the inter hop of an allreduce.

    dtype: wire dtype ("int8" or "float8_e4m3fn");
    chunk: elements per scale block;
    error_feedback: carry the per-member compression residual into the
    next call (the caller owns the residual buffer between calls);
    stochastic_rounding: int8 only, and only where the caller passes a
    generator: round ``floor(y + u)`` for u ~ U[0, 1), unbiased per element.
    """

    dtype: str = "int8"
    chunk: int = 4096
    error_feedback: bool = True
    stochastic_rounding: bool = False

    def __post_init__(self):
        if self.dtype not in _WIRE:
            raise ValueError(
                f"unsupported wire dtype {self.dtype!r}; pick one of "
                f"{sorted(_WIRE)}")
        if self.chunk <= 0:
            raise ValueError("chunk must be positive")
        if self.stochastic_rounding and self.dtype != "int8":
            raise ValueError(
                "stochastic_rounding rounds on the uniform int8 grid; the "
                "fp8 grid is non-uniform (per-exponent quantum) and has no "
                "unbiased dither here — use dtype='int8' or disable it")

    # ------------------------------------------------------------ properties
    @property
    def wire_dtype(self) -> torch.dtype:
        return _WIRE[self.dtype][0]

    @property
    def qmax(self) -> float:
        return _WIRE[self.dtype][1]

    @property
    def _inv_qmax(self) -> float:
        """1/qmax rounded to f32: XLA compiles the JAX package's
        ``amax / qmax`` (a division by a constant) to this product in every
        program the package runs it in."""
        return float(torch.tensor(1.0) / torch.tensor(self.qmax))

    def key(self) -> tuple:
        return (self.dtype, self.chunk, self.error_feedback,
                self.stochastic_rounding)

    def padded_size(self, n: int) -> int:
        """Smallest multiple of `chunk` holding n elements."""
        return ((n + self.chunk - 1) // self.chunk) * self.chunk

    def wire_bytes(self, n: int) -> int:
        """Wire bytes for one member's padded contribution (payload +
        scales)."""
        np_ = self.padded_size(n)
        return np_ * self.wire_dtype.itemsize + (np_ // self.chunk) * 4

    # ------------------------------------------------------------------ math
    def quantize(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat f32 [n] (n % chunk == 0) -> (q [nc, chunk], scales [nc, 1]).

        scale = amax · f32(1/qmax) (1 where amax is 0), the JAX package's
        bits under `jit`; op by op JAX divides by qmax instead, which can
        differ in the last bit. Round half to even, clip to ±qmax, cast to
        the wire dtype (fp8: clip, then the cast rounds). With
        `stochastic_rounding` and a generator, int8 rounds
        ``floor(y + u)``; each member must seed its own generator, or the
        dither correlates across members."""
        xc = x.reshape(-1, self.chunk)
        amax = xc.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax * self._inv_qmax,
                            torch.ones_like(amax))
        y = xc / scale
        if self.dtype == "int8":
            if self.stochastic_rounding and generator is not None:
                u = torch.rand(y.shape, generator=generator,
                               device=y.device, dtype=y.dtype)
                y = torch.floor(y + u)
            else:
                y = torch.round(y)
        return y.clamp(-self.qmax, self.qmax).to(self.wire_dtype), scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
        return (q.to(torch.float32) * scale).reshape(-1)

    # -------------------------------------------------- inter-hop allreduce
    def _gather_sum(self, q: torch.Tensor, scale: torch.Tensor, comm,
                    shape) -> torch.Tensor:
        """All-gather q and scales over `comm`, dequantize, sum in rank
        order."""
        world = comm.size
        wire = _on_wire(q).reshape(-1)
        qg = comm.all_gather(wire.new_empty(world * wire.numel()), wire)
        qg = qg.view(self.wire_dtype).view((world,) + tuple(q.shape))
        sc = scale.reshape(-1)
        sg = comm.all_gather(sc.new_empty(world * sc.numel()), sc)
        sg = sg.view((world,) + tuple(scale.shape))
        return _dequantize_sum(qg, sg).reshape(shape)

    def inter_allreduce(self, x: torch.Tensor, comm,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Quantized SUM of x over `comm` by all-gather: the wire carries the
        quantized blocks; dequantize and the f32 sum happen locally."""
        q, scale = self.quantize(x, generator)
        return self._gather_sum(q, scale, comm, x.shape)

    def inter_allreduce_ef(self, x: torch.Tensor, residual: torch.Tensor,
                           comm, generator: Optional[torch.Generator] = None
                           ) -> tuple:
        """Error-feedback variant: returns (reduced, new_residual)."""
        xc = x + residual
        q, scale = self.quantize(xc, generator)
        return self._gather_sum(q, scale, comm, x.shape), \
            self._residual(xc, q, scale)

    def _residual(self, xc: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
        """xc - dequantize(q, scale), rounded once (an FMA, as XLA compiles
        it)."""
        return _fma(-q.to(torch.float32), scale,
                    xc.reshape(q.shape)).reshape(xc.shape)

    def ring_allreduce(self, x: torch.Tensor, comm,
                       residual: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """Quantized SUM of x over `comm` by a send/recv ring: world-1
        rounds, each moving one packed int8 buffer [nc, chunk + 4] (the
        scales bit-cast into its tail) to the next member, the hop's send
        and recv grouped (`Comm.exchange`). Same wire bytes as the gather
        form. Contributions land in a [world, ...] buffer
        indexed by SOURCE rank and are summed in that order, so every member
        computes the same bits as `inter_allreduce`. Returns `reduced`, or
        (reduced, new_residual) when `residual` is given."""
        xc = x if residual is None else x + residual
        q, scale = self.quantize(xc, generator)
        nc, C = q.shape
        pack = torch.cat([_on_wire(q).view(torch.int8),
                          scale.contiguous().view(torch.int8)], dim=1)
        world, idx = comm.size, comm.rank
        buf = pack.new_empty((world,) + tuple(pack.shape))
        buf[idx] = pack
        cur, src = pack, idx
        for _ in range(world - 1):
            nxt = torch.empty_like(pack)
            comm.exchange(cur, (idx + 1) % world, nxt, (idx - 1) % world)
            src = (src - 1) % world
            buf[src] = nxt
            cur = nxt
        qg = buf[:, :, :C].contiguous().view(self.wire_dtype)
        sg = buf[:, :, C:].contiguous().view(torch.float32)   # [world, nc, 1]
        out = _dequantize_sum(qg, sg).reshape(x.shape)
        if residual is None:
            return out
        return out, self._residual(xc, q, scale)


__all__ = ["QuantizedAllreduce"]
