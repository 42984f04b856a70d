"""Break down the bf16 K1+K2+K3 gradient error against exact attention for
one kernel case of chip_smoke.py, on a CUDA card:

    PYTHONPATH=. python tests/grad_bound_diagnosis.py

It draws the inputs of the `b2-t2048` case (B=2 H=12 T=2048 Dh=64 bf16
causal) as chip_smoke.py's phases 2 draw them when the two Llama cases
(`LLAMA_SHAPES`) come before it in `KERNEL_CASES`, and for dQ, dK and dV
prints the worst element against chip_smoke's TOL_GRAD_MHA bound
(2e-2 + 2e-2 |exact|) for: the kernels, their plain versions, the CPU
emulations of their tensor-core arithmetic (tests/test_torch_flash_tc.py)
and PyTorch's SDPA, each against autograd through mha_reference in f32.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
import test_torch_flash_tc as emu  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402

LLAMA_FIRST = ("train-path", "forward-path", *cs.LLAMA_SHAPES)


def _draw():
    """q, k, v, dO of b2-t2048 as the phases draw them with the Llama cases
    placed after the GPT-2 forward path's."""
    cases = {c[0]: c[1:] for c in cs.KERNEL_CASES}
    order = list(LLAMA_FIRST) + [n for n in cases if n not in LLAMA_FIRST]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in order:                   # phase_kernels' draws
        B, H, T, Dh, dtype, _, layout = cases[name]
        cs._case_inputs(gen, B, H, T, Dh, dtype, layout)
    for name in order:                   # phase_backward's, up to the case
        B, H, T, Dh, dtype, _, layout = cases[name]
        inputs = cs._case_inputs(gen, B, H, T, Dh, dtype, layout)
        if name == "b2-t2048":
            return inputs


def _worst(label, got, ref, atol=2e-2, rtol=2e-2):
    got, ref = got.float().cuda(), ref.float().cuda()
    ratio = (got - ref).abs() / (atol + rtol * ref.abs())
    idx = tuple(int(i) for i in torch.unravel_index(ratio.argmax(),
                                                    ref.shape))
    print(f"{label}: max |d| {float((got - ref).abs().max()):.4g}, worst "
          f"ratio to the bound {float(ratio.max()):.3f} at {idx} (got "
          f"{float(got[idx]):.6g}, exact {float(ref[idx]):.6g}), "
          f"{int((ratio > 1).sum())} elements past it", flush=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _draw()
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    plain_dq, plain_delta = fa._bwd_dq_reference(q, k, v, out, lse, do, True,
                                                 scale, 128, 128)
    plain = (plain_dq, *fa._bwd_dkv_reference(q, k, v, do, lse, plain_delta,
                                              True, scale, 128, 128))
    exact_in = [t.float().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(fa.mha_reference(*exact_in, True), exact_in,
                                do.float())
    qc, kc, vc, doc, lc = (t.cpu() for t in (q, k, v, do, lse))
    e_out = emu.k1_tensor_core_emulation(qc, kc, vc, True, scale)
    e_dq, e_delta = emu.k2_tensor_core_emulation(qc, kc, vc, e_out, lc, doc,
                                                 True, scale)
    emulated = (e_dq, *emu.k3_tensor_core_emulation(qc, kc, vc, doc, lc,
                                                    e_delta, True, scale))
    sdpa_in = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *sdpa_in, is_causal=True)
    sdpa = torch.autograd.grad(sdpa_out, sdpa_in, do)
    print(f"card: {cs.gpu_line()}")
    for i, name in enumerate(("dQ", "dK", "dV")):
        kern = (dq, dk, dv)[i]
        for label, got in (("kernels", kern), ("plain versions", plain[i]),
                           ("emulation", emulated[i]), ("sdpa", sdpa[i])):
            _worst(f"{name} {label} vs exact", got, exact[i])
        _worst(f"{name} kernels vs emulation", kern, emulated[i], 1e-2, 1e-2)


if __name__ == "__main__":
    main()
