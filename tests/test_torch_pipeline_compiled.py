"""The channel-driven 1F1B pipeline and compiled DAGs over GPT-2 in the port.

- The port's mirror of `tests/test_pipeline_compiled.py` (2 cases): two
  `ChannelPipelineStage` actors on the MLP stage (D=12, M=4, 4 steps)
  through `CompiledPipeline`, on host edges and on device edges, held
  against that file's in-process JAX `_reference_run` (full-batch SGD over
  the chained stages) at rtol 1e-4, atol 1e-5, from the same initial
  params; and the eager GPipe schedule (`eager_pipeline_step`) on the
  same trajectory.
- `_schedule(M)` is the JAX stage's for F in 1..4 and M in 1..8.
- GPT-2-tiny in 2 stages through `CompiledPipeline` (f32): stage 0 is the
  embedding and block 0, stage 1 block 1, the unembedding and the
  cross-entropy, each built from `models.gpt2`'s `embed`, `_block` and
  `unembed` here, as the JAX tests build theirs from `mlp_stage_fn`.
  GPT-2 ties `wte`: stage 0 embeds with it and stage 1 unembeds with it,
  and across actors each stage updates its own copy, so the stages are
  UNTIED here, and the reference chains the same untied stages: the JAX
  package's `embed`, `_block` and `unembed`, full-batch `value_and_grad`
  and SGD, on the same weights (made by the JAX package, carried across
  as numpy). Losses and every param after 3 steps within atol 1e-5, rtol
  1e-4 (ROADMAP's trajectory tolerance).
- A compiled DAG over GPT-2-tiny's two halves (actor A: embedding and
  block 0, its output a device object; actor B: block 1 and the
  unembedding): logits bit-equal to the port's one-process `gpt2.forward`
  on the same weights (both at one torch thread), within 1e-4 of JAX's.
Every ring of a pipeline and of a DAG is gone from /dev/shm after `close`
or `teardown`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
import test_pipeline_compiled as JPC
from ray_tpu.models import gpt2 as J
from ray_tpu.models import lm as JL
from ray_tpu.parallel import pipeline as JP
from ray_tpu_torch.core.native_store import native_available
from ray_tpu_torch.models import gpt2 as P
from ray_tpu_torch.parallel import pipeline as PP
from ray_tpu_torch.utils.tree import nest

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")

D, M, LR, STEPS = JPC.D, JPC.M, JPC.LR, JPC.STEPS
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=10)
    yield
    ray_tpu_torch.shutdown()


def _mlp_params():
    """The JAX package's initial stage params, as numpy."""
    return [{k: np.asarray(v) for k, v in JP.init_mlp_stage(i, D, D).items()}
            for i in range(2)]


def _rings_left(pipe) -> list:
    return [n for n in pipe.names.values() if os.path.exists(f"/dev/shm/{n}")]


def _kill(actors):
    for a in actors:
        ray_tpu_torch.kill(a)


def test_compiled_1f1b_matches_reference_and_eager(cluster):
    X, Y = JPC._data()
    ref_losses, ref_params = JPC._reference_run()
    params = _mlp_params()

    stages = PP.CompiledPipeline.build_stages(
        PP.mlp_stage_fn, params, lr=LR, loss_fn=PP.mse_loss, device="cpu")
    pipe = PP.CompiledPipeline(stages, n_microbatches=M, max_inflight=4)
    try:
        losses = [pipe.step(X, Y) for _ in range(STEPS)]
    finally:
        pipe.close()
    assert _rings_left(pipe) == []
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    got = pipe.get_params()
    for gp, rp in zip(got, ref_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(gp[k], np.asarray(rp[k]), **TOL)
    _kill(stages)

    # the eager GPipe baseline (dynamic actor calls) reproduces the same
    # trajectory — the compiled mode changes the transport, not the math
    stages2 = PP.CompiledPipeline.build_stages(
        PP.mlp_stage_fn, params, lr=LR, loss_fn=PP.mse_loss, device="cpu")
    eager = [PP.eager_pipeline_step(stages2, X, Y, M, timeout=60)
             for _ in range(STEPS)]
    np.testing.assert_allclose(eager, ref_losses, **TOL)
    got = ray_tpu_torch.get([s.get_params.remote() for s in stages2],
                            timeout=60)
    for gp, rp in zip(got, ref_params):
        np.testing.assert_allclose(gp["w"], np.asarray(rp["w"]), **TOL)
    _kill(stages2)


def test_compiled_1f1b_device_edges(cluster):
    """tensor_transport='device': stage hand-offs carry descriptors of
    device objects (only a tiny dict rides the ring) and the numerics
    still match."""
    X, Y = JPC._data()
    ref_losses, _ = JPC._reference_run()
    stages = PP.CompiledPipeline.build_stages(
        PP.mlp_stage_fn, _mlp_params(), lr=LR, loss_fn=PP.mse_loss,
        device="cpu")
    pipe = PP.CompiledPipeline(stages, n_microbatches=M, max_inflight=3,
                               tensor_transport="device")
    try:
        losses = [pipe.step(X, Y) for _ in range(2)]
    finally:
        pipe.close(kill_actors=True)
    assert _rings_left(pipe) == []
    np.testing.assert_allclose(losses, ref_losses[:2], **TOL)


def test_schedule_matches_jax_stage():
    jparams = JP.init_mlp_stage(0, 2, 2)
    pparams = {k: np.asarray(v) for k, v in jparams.items()}
    for F in range(1, 5):
        for pos in range(F):
            j = JP.ChannelPipelineStage(JP.mlp_stage_fn, jparams,
                                        position=pos, n_stages=F)
            p = PP.ChannelPipelineStage(PP.mlp_stage_fn, pparams,
                                        position=pos, n_stages=F,
                                        device="cpu")
            for m in range(1, 9):
                assert p._schedule(m) == j._schedule(m), (F, pos, m)


# ------------------------------------------------------------------ GPT-2
GPT_B, GPT_T, GPT_M, GPT_LR, GPT_STEPS = 8, 32, 4, 0.1, 3


def _jcfg():
    return J.GPT2Config.preset("gpt2-tiny", dtype=jnp.float32, remat=False)


def _pcfg():
    return P.GPT2Config.preset("gpt2-tiny", dtype=torch.float32,
                               remat=False, attn_impl="flash")


def _flat_jax(params) -> dict:
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in kp)] = \
            np.asarray(leaf)
    return out


def _split(flat: dict, n_stages: int) -> list:
    """GPT-2's path-keyed numpy leaves -> one untied param tree a stage:
    the first holds wte and wpe, the last ln_f and its own copy of wte,
    each its share of the stacked blocks."""
    L = flat["blocks/attn/wqkv"].shape[0]
    per = L // n_stages
    out = []
    for s in range(n_stages):
        tree = {k: v[s * per:(s + 1) * per] for k, v in flat.items()
                if k.startswith("blocks/")}
        if s == 0:
            tree.update(wte=flat["wte"].copy(), wpe=flat["wpe"])
        if s == n_stages - 1:
            tree.update({k: v for k, v in flat.items()
                         if k.startswith("ln_f/")})
            tree["wte"] = flat["wte"].copy()
        out.append(nest(tree))
    return out


def _port_stage_fns(cfg, n_stages: int) -> list:
    """The stage functions of the port: `embed` on the first, `unembed`
    on the last, each stage's blocks by `_block`."""
    def blocks(p, x):
        for bp in P._layers(p["blocks"]):
            x = P._block(x, bp, cfg)
        return x

    def stage(pos):
        def fn(p, x):
            if pos == 0:
                x = P.embed(p, x, cfg)
            x = blocks(p, x)
            if pos == n_stages - 1:
                x = P.unembed(p, x, cfg)
            return x
        return fn

    return [stage(i) for i in range(n_stages)]


def _port_ce(logits, targets):
    from ray_tpu_torch.models import lm

    return lm.cross_entropy(logits, targets)


def _jax_stage(cfg, pos: int, n_stages: int):
    def fn(p, x):
        if pos == 0:
            x = J.embed(p, x, cfg)
        L = p["blocks"]["attn"]["wqkv"].shape[0]
        for i in range(L):
            x = J._block(x, jax.tree.map(lambda a: a[i], p["blocks"]), cfg)
        if pos == n_stages - 1:
            x = J.unembed(p, x, cfg)
        return x
    return fn


def _gpt_data():
    tokens = np.random.default_rng(3).integers(
        0, 512, (GPT_B, GPT_T + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _jax_gpt_reference(stage_params: list) -> tuple:
    """Full-batch value_and_grad + SGD over the chained untied stages."""
    cfg = _jcfg()
    fns = [_jax_stage(cfg, i, len(stage_params))
           for i in range(len(stage_params))]
    x, y = _gpt_data()
    params = [jax.tree.map(jnp.asarray, p) for p in stage_params]

    def loss(ps, x, y):
        for fn, p in zip(fns, ps):
            x = fn(p, x)
        return JL.cross_entropy(x, y)

    losses = []
    for _ in range(GPT_STEPS):
        val, g = jax.value_and_grad(loss)(params, jnp.asarray(x),
                                          jnp.asarray(y))
        params = jax.tree.map(lambda a, b: a - GPT_LR * b, params, g)
        losses.append(float(val))
    return losses, params


def test_gpt2_tiny_two_stages_match_jax(cluster):
    """GPT-2-tiny, 2 untied stages, 3 compiled 1F1B steps (M=4): losses
    and params after the last step within 1e-5/1e-4 of JAX's chained
    reference. Stage 0 takes token ids, so its backward gives no input
    gradient (JAX's float0)."""
    flat = _flat_jax(J.init_params(jax.random.key(0), _jcfg()))
    stage_params = _split(flat, 2)
    ref_losses, ref_params = _jax_gpt_reference(stage_params)
    x, y = _gpt_data()
    stages = PP.CompiledPipeline.build_stages(
        _port_stage_fns(_pcfg(), 2), stage_params, lr=GPT_LR,
        loss_fn=_port_ce, device="cpu")
    pipe = PP.CompiledPipeline(stages, n_microbatches=GPT_M,
                               channel_capacity=1 << 20)
    try:
        losses = [pipe.step(torch.from_numpy(x).long(),
                            torch.from_numpy(y).long())
                  for _ in range(GPT_STEPS)]
    finally:
        pipe.close()   # joins the stage loops: every update has landed
    got = pipe.get_params()
    _kill(stages)
    assert _rings_left(pipe) == []
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    assert losses[-1] < losses[0]
    for gp, rp in zip(got, ref_params):
        want = _flat_jax(rp)
        have = {"/".join(k): v for k, v in _walk(gp)}
        assert sorted(have) == sorted(want)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], err_msg=k, **TOL)


def _walk(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_compiled_dag_over_gpt2_halves(cluster):
    """Two actors run GPT-2-tiny's halves as a compiled DAG, the hidden
    state between them a device object: the logits are bit-equal to the
    port's one-process forward and within 1e-4 of JAX's."""
    from ray_tpu_torch.dag import InputNode

    jp = J.init_params(jax.random.key(0), _jcfg())
    flat = _flat_jax(jp)
    halves = _split(flat, 2)
    fns = _port_stage_fns(_pcfg(), 2)

    class Half:
        def __init__(self, fn, params):
            from ray_tpu_torch.utils.tree import tree_map

            torch.set_num_threads(1)
            self.fn = fn
            self.params = tree_map(torch.from_numpy, params)

        @ray_tpu_torch.method(tensor_transport="device")
        def hidden(self, tokens):
            with torch.no_grad():
                return self.fn(self.params, tokens)

        def logits(self, x):
            with torch.no_grad():
                return self.fn(self.params, x)

    Half = ray_tpu_torch.remote(Half)
    a, b = Half.remote(fns[0], halves[0]), Half.remote(fns[1], halves[1])
    tokens = torch.from_numpy(_gpt_data()[0]).long()
    with InputNode() as inp:
        dag = b.logits.bind(a.hidden.bind(inp))
    cdag = dag.experimental_compile(channel_capacity=1 << 20)
    try:
        outs = [cdag.execute(tokens).get(timeout=60) for _ in range(2)]
    finally:
        cdag.teardown(kill_actors=True)
    assert [n for n in cdag.chan_names.values()
            if os.path.exists(f"/dev/shm/{n}")] == []

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            want = P.forward(P.params_from_numpy(flat, _pcfg(), device="cpu"),
                             tokens, _pcfg())
    finally:
        torch.set_num_threads(threads)
    for out in outs:
        assert out.dtype == want.dtype and out.shape == want.shape
        assert torch.equal(out, want)
    jax_logits = np.asarray(J.forward(jp, jnp.asarray(tokens.numpy()),
                                      _jcfg()))
    np.testing.assert_allclose(outs[0].numpy(), jax_logits, atol=1e-4,
                               rtol=0)
