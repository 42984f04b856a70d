"""ray_tpu_torch.models.gpt2 / lm against the JAX package on the same weights.

Weights are made by the JAX package (gpt2.init_params) and carried across as
the path-keyed numpy leaves that gpt2.save_params writes. Everything runs in
float32 on `gpt2-tiny`; logits agree to atol=1e-4 (f32 through 2 layers: the
measured gap is ~1e-6, the bound leaves room for another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as J
from ray_tpu.models import lm as JL
from ray_tpu_torch.models import gpt2 as P
from ray_tpu_torch.models import lm as PL

TOL = dict(atol=1e-4, rtol=1e-4)


def _jcfg(**kw):
    return J.GPT2Config.preset("gpt2-tiny", dtype=jnp.float32, remat=False,
                               **kw)


def _pcfg(**kw):
    return P.GPT2Config.preset("gpt2-tiny", dtype=torch.float32, **kw)


def _flat(params):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in kp)] = \
            np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def weights():
    jp = J.init_params(jax.random.key(0), _jcfg())
    flat = _flat(jp)
    return jp, P.params_from_numpy(flat, _pcfg(), device="cpu"), flat


def _tokens(B, T, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def test_params_numpy_roundtrip_bitwise(weights):
    _, pp, flat = weights
    back = P.params_to_numpy(P.params_from_numpy(flat, device="cpu"))
    assert list(back) == list(flat)      # same keys, same (sorted) order
    for key in flat:
        assert back[key].dtype == flat[key].dtype
        np.testing.assert_array_equal(back[key], flat[key])
    assert sum(v.size for v in flat.values()) == P.num_params(_pcfg()) \
        == J.num_params(_jcfg())


def test_checkpoint_jax_to_port_bitwise(weights, tmp_path):
    jp, _, flat = weights
    J.save_params(str(tmp_path), jp, _jcfg())
    pp, cfg = P.load_params(str(tmp_path), _pcfg(), device="cpu")
    assert (cfg.n_layer, cfg.d_model, cfg.vocab_size) == (2, 128, 512)
    for key, arr in P.params_to_numpy(pp).items():
        np.testing.assert_array_equal(arr, flat[key])


def test_checkpoint_port_to_jax_bitwise(tmp_path):
    cfg = _pcfg(n_layer=3)
    pp = P.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    P.save_params(str(tmp_path), pp, cfg)
    jp, jcfg = J.load_params(str(tmp_path), _jcfg())
    assert jcfg.n_layer == 3
    want = P.params_to_numpy(pp)
    for key, arr in _flat(jp).items():
        np.testing.assert_array_equal(arr, want[key])


def test_load_rejects_wrong_shapes(weights, tmp_path):
    jp, _, _ = weights
    J.save_params(str(tmp_path), jp, _jcfg())
    bad = dataclasses.replace(_pcfg(), d_ff=256)
    with pytest.raises(ValueError, match="shape"):
        P.params_from_numpy(_flat(jp), bad, device="cpu")


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_matches_jax(weights, attn_impl):
    jp, pp, _ = weights
    toks = _tokens(2, 64)
    want = J.forward(jp, jnp.asarray(toks), _jcfg(attn_impl=attn_impl))
    got = P.forward(pp, torch.from_numpy(toks), _pcfg(attn_impl=attn_impl))
    assert got.shape == (2, 64, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("key", ["tokens", "inputs"])
def test_loss_matches_jax(weights, key):
    jp, pp, _ = weights
    toks = _tokens(2, 33, seed=2)
    if key == "tokens":
        jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
            toks)}
    else:
        jb = {"inputs": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
        pb = {"inputs": torch.from_numpy(toks[:, :-1]),
              "targets": torch.from_numpy(toks[:, 1:])}
    want = float(J.loss_fn(jp, jb, _jcfg()))
    got = float(P.loss_fn(pp, pb, _pcfg()))
    assert got == pytest.approx(want, abs=1e-5)
    # chunked cross-entropy: the same value, 8 tokens at a time
    want = float(J.loss_fn(jp, jb, _jcfg(ce_chunk=8)))
    assert float(P.loss_fn(pp, pb, _pcfg(ce_chunk=8))) == \
        pytest.approx(want, abs=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    tgt = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt)))
    got = float(PL.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(tgt)))
    assert got == pytest.approx(want, abs=1e-6)


def test_resolve_attn_impl_rules():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert PL.resolve_attn_impl("auto", 1024, cpu) == "dense"
    assert PL.resolve_attn_impl("auto", 1024, gpu) == "flash"
    assert PL.resolve_attn_impl("auto", 1000, gpu) == "dense"
    assert PL.resolve_attn_impl("flash", 64, cpu) == "flash"
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError):
            PL.resolve_attn_impl(impl, 1024, gpu)


def _cache(B, T, seed):
    rng = np.random.default_rng(seed)
    shape = (2, B, 4, T, 32)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def _jax_cache(ck, cv):
    return {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}


def _port_cache(ck, cv):
    return {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}


def _assert_cache(got, want):
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def test_decode_step_matches_jax(weights):
    jp, pp, _ = weights
    ck, cv = _cache(3, 32, seed=4)
    toks = np.array([5, 77, 300], np.int32)
    pos = np.array([0, 31, 9], np.int32)
    active = np.array([True, True, False])
    jl, jc = J.decode_step(jp, _jax_cache(ck, cv), jnp.asarray(toks),
                           jnp.asarray(pos), jnp.asarray(active), _jcfg())
    pl, pc = P.decode_step(pp, _port_cache(ck, cv), torch.from_numpy(toks),
                           torch.from_numpy(pos), torch.from_numpy(active),
                           _pcfg())
    np.testing.assert_allclose(pl.numpy()[:2], np.asarray(jl)[:2], **TOL)
    assert pl.dtype == torch.float32
    _assert_cache(pc, jc)
    # the inactive lane is untouched, bit for bit
    np.testing.assert_array_equal(pc["k"][:, 2].numpy(), ck[:, 2])
    np.testing.assert_array_equal(pc["v"][:, 2].numpy(), cv[:, 2])


@pytest.mark.parametrize("pos0,length", [
    ([0, 8, 3], [8, 5, 0]),          # prompt start, mid-chunk, zero length
    ([27, 30, 2], [5, 2, 8]),        # window end: pos0 > T - C, JAX clamps
])
def test_prefill_chunk_matches_jax(weights, pos0, length):
    jp, pp, _ = weights
    B, T, C = 3, 32, 8
    ck, cv = _cache(B, T, seed=5)
    toks = _tokens(B, C, seed=6)
    pos0, length = np.array(pos0, np.int32), np.array(length, np.int32)
    active = np.array([True, True, False]) if length[2] == 8 else length > 0
    jl, jc = J.prefill_chunk(jp, _jax_cache(ck, cv), jnp.asarray(toks),
                             jnp.asarray(pos0), jnp.asarray(length),
                             jnp.asarray(active), _jcfg())
    pl, pc = P.prefill_chunk(pp, _port_cache(ck, cv), torch.from_numpy(toks),
                             torch.from_numpy(pos0), torch.from_numpy(length),
                             torch.from_numpy(active), _pcfg())
    live = active & (length > 0)
    np.testing.assert_allclose(pl.numpy()[live], np.asarray(jl)[live], **TOL)
    _assert_cache(pc, jc)
    for b in np.flatnonzero(~live):
        np.testing.assert_array_equal(pc["k"][:, b].numpy(), ck[:, b])


def test_prefill_chunks_equal_forward(weights):
    # a prompt prefilled chunk by chunk ends on forward's last logits
    _, pp, _ = weights
    cfg = _pcfg()
    toks = torch.from_numpy(_tokens(1, 40, seed=7))
    want = P.forward(pp, toks, cfg)[0, -1]
    cache = P.init_cache(cfg, 2, 64, device="cpu")
    for p0 in range(0, 40, 16):
        n = min(16, 40 - p0)
        chunk = torch.zeros((2, 16), dtype=torch.long)
        chunk[0, :n] = toks[0, p0:p0 + n]
        lengths = torch.tensor([n, 0])
        logits, cache = P.prefill_chunk(pp, cache, chunk, torch.tensor(
            [p0, 0]), lengths, lengths > 0, cfg)
    np.testing.assert_allclose(logits[0].numpy(), want.numpy(), **TOL)


def test_bf16_forward_close_to_jax(weights):
    # bf16 compute rounds at other places in the two frameworks: compare
    # against the f32 logits' scale (|logits| ~ 1.6 here) with a bf16 bound
    jp, pp, _ = weights
    toks = _tokens(2, 32, seed=8)
    jcfg = J.GPT2Config.preset("gpt2-tiny", remat=False, attn_impl="dense")
    pcfg = P.GPT2Config.preset("gpt2-tiny", attn_impl="dense")
    want = np.asarray(J.forward(jp, jnp.asarray(toks), jcfg), np.float32)
    got = P.forward(pp, torch.from_numpy(toks), pcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2,
                               rtol=5e-2)


def test_entry_points_default_to_cuda():
    cfg = _pcfg()
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert P.init_params(gen, cfg)["wte"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        P.init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.init_cache(cfg, 1)
