"""The port's dense transformer against the reference, at float32, with
the reference's parameters carried over by
``bridge.transformer_params_from_arrays``.

Tolerance: logits and hidden states within rtol/atol 2e-4, the bound
tests/test_kernels.py holds the flash-attention kernel to (the reference's
``_attention`` divides by sqrt(Dh) and masks with -1e30, the port's
attention multiplies by 1/sqrt(Dh) and masks with -inf, and the matrix
products sum in other orders); greedy tokens identical; int8 caches equal
whose codes differ by at most one step, in at most 0.1% of the entries
(a value that sits at a rounding boundary of its scale), and whose scales
agree within the same bound. The comparisons run on the CPU,
where the port's attention is the kernel's plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as J
from repro_torch.bridge import transformer_params_from_arrays
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

TOL = 2e-4
LM_ARCHS = ("granite-3-2b", "internlm2-1.8b", "phi4-mini-3.8b")


def _pair(jcfg, tcfg, seed=0):
    jparams = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, transformer_params_from_arrays(tcfg, tree, device="cpu")


def _smoke_pair(arch_id, kv_quant=False):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).smoke(),
                               kv_quant=kv_quant)
    tcfg = dataclasses.replace(get_arch(arch_id).smoke(), kv_quant=kv_quant)
    return jcfg, tcfg, *_pair(jcfg, tcfg)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), rtol=tol, atol=tol)


def _tokens(rng, vocab, shape):
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_forward_and_logits_match(arch_id):
    jcfg, tcfg, jp, tp = _smoke_pair(arch_id)
    jt, tt = _tokens(np.random.default_rng(0), jcfg.vocab, (2, 12))
    jh, _, _ = J.forward(jcfg, jp, jt)
    th, _, _ = T.forward(tcfg, tp, tt)
    _close(jh, th)
    _close(J.logits_fn(jcfg, jp, jh), T.logits_fn(tcfg, tp, th))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_and_decode_match(arch_id, kv_quant):
    """Prefill 10 tokens into a 16-position cache, then 4 greedy decode
    steps: logits, caches and tokens against the reference's."""
    jcfg, tcfg, jp, tp = _smoke_pair(arch_id, kv_quant)
    jt, tt = _tokens(np.random.default_rng(1), jcfg.vocab, (2, 10))
    jl, jc = J.prefill(jcfg, jp, jt, max_len=16)
    tl, tc = T.prefill(tcfg, tp, tt, max_len=16)
    _close(jl, tl)
    assert set(jc) == set(tc)
    if kv_quant:
        assert tc["k"].dtype == torch.int8
        for a, s in (("k", "k_scale"), ("v", "v_scale")):
            _close(jc[s], tc[s])
            step = np.abs(np.asarray(jc[a], np.int32)
                          - tc[a].numpy().astype(np.int32))
            assert step.max() <= 1 and step.mean() <= 1e-3
    else:
        for key in jc:
            _close(jc[key], tc[key])
    jtok = jl[:, -1].argmax(-1)[:, None]
    ttok = tl[:, -1].argmax(-1)[:, None]
    for pos in range(10, 14):
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jl, jc = J.decode_step(jcfg, jp, jtok, jc, jnp.int32(pos))
        tl, tc = T.decode_step(tcfg, tp, ttok, tc, pos)
        _close(jl, tl)
        jtok = jl[:, -1].argmax(-1)[:, None]
        ttok = tl[:, -1].argmax(-1)[:, None]


def test_splade_encode_matches():
    """A small bidirectional sparse-head encoder (the reduced shape of
    examples/train_sparse_encoder.py) with a padding mask."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
              vocab=500, causal=False, rope=False, max_position=24,
              sparse_head=True, remat=False)
    jcfg = J.TransformerConfig(**kw, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**kw, compute_dtype=torch.float32)
    jp, tp = _pair(jcfg, tcfg, seed=2)
    rng = np.random.default_rng(2)
    jt, tt = _tokens(rng, 500, (3, 24))
    mask = (np.arange(24)[None] < np.array([[24], [10], [1]])).astype(
        np.int32)
    _close(J.splade_encode(jcfg, jp, jt, jnp.asarray(mask)),
           T.splade_encode(tcfg, tp, tt, torch.from_numpy(mask)))


def test_lm_greedy_decode_loop_consistency():
    """Greedy decode token-by-token == argmax of the full forward pass (the
    port of tests/test_model_invariants.py's check), and the tokens equal
    the reference's."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=131, remat=False)
    jcfg = J.TransformerConfig(**kw, compute_dtype=jnp.float32)
    cfg = T.TransformerConfig(**kw, compute_dtype=torch.float32)
    jp, params = _pair(jcfg, cfg, seed=5)
    _, toks = _tokens(np.random.default_rng(6), cfg.vocab, (1, 8))
    ctx = toks
    for _ in range(4):
        h, _, _ = T.forward(cfg, params, ctx)
        nxt = T.logits_fn(cfg, params, h)[:, -1].argmax(-1)[:, None]
        ctx = torch.cat([ctx, nxt.to(ctx.dtype)], dim=1)
    lg, cache = T.prefill(cfg, params, toks, max_len=16)
    cur = lg[:, -1].argmax(-1)[:, None]
    got = [int(cur[0, 0])]
    for pos in range(8, 11):
        lg, cache = T.decode_step(cfg, params, cur, cache, pos)
        cur = lg[:, -1].argmax(-1)[:, None]
        got.append(int(cur[0, 0]))
    assert got == ctx[0, 8:].tolist()
    jctx = jnp.asarray(toks.numpy())
    for _ in range(4):
        h, _, _ = J.forward(jcfg, jp, jctx)
        nxt = J.logits_fn(jcfg, jp, h)[:, -1].argmax(-1)[:, None]
        jctx = jnp.concatenate([jctx, nxt.astype(jctx.dtype)], axis=1)
    assert got == np.asarray(jctx[0, 8:]).tolist()


def test_int8_kv_cache_decode_close_to_fp():
    """The int8 KV cache tracks the full-precision decode distribution (the
    port of tests/test_arch_smoke.py's check)."""
    cfg = T.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=128, vocab=211,
                              compute_dtype=torch.float32, remat=False)
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    _, cache = T.prefill(cfg, params, toks[:, :16], max_len=24)
    _, cacheq = T.prefill(cfg_q, params, toks[:, :16], max_len=24)
    assert cacheq["k"].dtype == torch.int8
    l1, _ = T.decode_step(cfg, params, toks[:, 16:17], cache, 16)
    l2, _ = T.decode_step(cfg_q, params, toks[:, 16:17], cacheq, 16)
    p1 = torch.softmax(l1[:, 0], -1)
    p2 = torch.softmax(l2[:, 0], -1)
    assert float((p1 - p2).abs().max()) < 0.05
    assert torch.equal(p1.argmax(-1), p2.argmax(-1))


def test_quantize_kv_matches_reference():
    x = np.random.default_rng(7).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    jq, js = J.quantize_kv(jnp.asarray(x))
    tq, ts = T.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-7)


def test_config_counts_and_shapes_match_reference():
    for arch_id in LM_ARCHS:
        jcfg, tcfg = jax_get_arch(arch_id).config(), get_arch(arch_id).config()
        assert (tcfg.param_count(), tcfg.active_param_count(),
                tcfg.head_dim, tcfg.padded_vocab) == (
            jcfg.param_count(), jcfg.active_param_count(), jcfg.head_dim,
            jcfg.padded_vocab)
    cfg = get_arch("granite-3-2b").config()
    gen = torch.Generator().manual_seed(0)
    small = dataclasses.replace(cfg, n_layers=1, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=96, vocab=300)
    params = T.init_params(small, gen)
    n = sum(t.numel() for t in params.values() if torch.is_tensor(t))
    n += sum(t.numel() for t in params["layers"].values())
    assert n == small.param_count()


@pytest.mark.parametrize("tie", [True, False])
def test_compute_params_serve_identical_logits(tie):
    """``compute_params`` makes once the casts each use makes (and holds
    the float32 head): bfloat16 prefill and decode logits identical to
    those of the float32 master tree."""
    cfg = dataclasses.replace(get_arch("granite-3-2b").smoke(),
                              compute_dtype=torch.bfloat16,
                              tie_embeddings=tie)
    master = T.init_params(cfg, torch.Generator().manual_seed(0))
    params = T.compute_params(cfg, master)
    assert params["head_f32"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    logits = []
    for tree in (master, params):
        lg, cache = T.prefill(cfg, tree, toks, max_len=12)
        nxt = lg[:, -1].argmax(-1)[:, None]
        logits += [lg, T.decode_step(cfg, tree, nxt, cache, 9)[0]]
    for a, b in zip(logits[:2], logits[2:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bridge_rejects_wrong_shapes():
    jcfg, tcfg, jp, _ = _smoke_pair("granite-3-2b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    other = dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1)
    with pytest.raises(ValueError, match="shapes"):
        transformer_params_from_arrays(other, tree, device="cpu")


def test_unported_paths_raise():
    from repro_torch.launch import steps as TS
    schnet = get_arch("schnet")
    with pytest.raises(ValueError, match="GNN cells are train-step cells"):
        TS.make_serve_step(schnet, "ogb_products",
                           TS.adapt_config(schnet, "ogb_products"))
    params = T.init_params(get_arch("granite-3-2b").smoke(),
                           torch.Generator().manual_seed(0))
    cache = T.init_cache(get_arch("granite-3-2b").smoke(), 1, 4, "cpu")
    with pytest.raises(ValueError, match="cannot take"):
        T.decode_step(get_arch("granite-3-2b").smoke(), params,
                      torch.zeros(1, 1, dtype=torch.int32), cache, 4)
