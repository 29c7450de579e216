"""The port's MoE layer (``models.transformer._moe_ffn``) against the
reference's, on the CPU, with the same inputs drawn by numpy from a seed.

The reference's routing and combine are closures under ``jax.vmap``; a spy
on its module's ``jax.vmap`` records each call's function and output, so
its dispatch (expert-sorted assignments: expert, slot, kept, token) is
compared with the port's as a set of kept (group, token, expert, slot),
and its own ``combine`` is run on expert outputs chosen here. XLA's CPU
runtime refuses the expert products' bfloat16 x bfloat16 -> float32 dot
("gecd,edf->gecf"); in the bfloat16 cases a second stand-in, for the
module's ``jnp``, widens the operands of such an einsum to float32 first:
the same values (a product of two bfloat16 values is exact in float32,
and the sum runs in float32 either way). Nothing in the JAX package
changes.

Tolerances:
- dispatch: identical (float32 and bfloat16). The router logits are
  float32 sums of exact products, equal on both sides to ~1e-6; each case
  asserts that no token's k-th and (k+1)-th logits lie within 1e-4, so no
  such difference can reorder them (the softmax keeps the logits' order).
- float32 outputs: rtol/atol 1e-5 (the expert products sum in other
  orders). bfloat16 outputs: max |d| <= 2^-6 max |ref| (the products round
  to bfloat16 once on each side, but their sums run in other orders and
  ``silu`` rounds at other places, so an element may differ by a few
  bfloat16 steps).
- the combine: bit-equal in bfloat16, on the same expert outputs and
  dispatch (both add each token's weighted outputs from zero in
  ascending-expert order, rounding to bfloat16 after every add).
- aux loss: within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as J
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

D, E, K, F = 16, 8, 2, 12
BF16_RTOL = 2.0 ** -6


class _VmapSpy:
    """Stands in for the reference module's ``jax``: records every
    ``vmap(fn)(*args)`` as (fn, output)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        def run(*args):
            out = jax.vmap(fn, *a, **kw)(*args)
            self.calls.append((fn, out))
            return out
        return run


class _Float32Dots:
    """Stands in for the reference module's ``jnp``: an einsum of two
    bfloat16 operands with a float32 result widens them to float32 first."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if (preferred_element_type == jnp.float32
                and all(o.dtype == jnp.bfloat16 for o in ops)):
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


def _weights(rng, e=E, d=D, f=F):
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * 0.3
    return router, wg, wu, wd


def _run_both(monkeypatch, x, weights, cf, dp, dtype, e=E, k=K):
    """(reference y, aux, its dispatch info and combine fn; the port's y,
    aux and dispatch) on the same inputs, cast to ``dtype``. The reference
    runs under ``jax.jit``, as its serve steps do (XLA's CPU runtime takes
    a bfloat16 product with a float32 result only in a compiled graph); the
    dispatch info leaves the graph as an output."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f = weights[1].shape[-1]
    spy = _VmapSpy()
    monkeypatch.setattr(J, "jax", spy)
    if dtype == torch.bfloat16:
        monkeypatch.setattr(J, "jnp", _Float32Dots())

    def ref(xj, *wj):
        spy.calls.clear()
        y, aux = J._moe_ffn(xj, *wj, J.MoEConfig(e, k, f, cf),
                            J.Rules(dp_size=dp))
        return y, aux, spy.calls[0][1][1]
    jy, jaux, info = jax.jit(ref)(jnp.asarray(x).astype(jdt),
                                  *(jnp.asarray(w) for w in weights))
    combine = spy.calls[1][0]
    monkeypatch.undo()
    tx = torch.from_numpy(x).to(dtype)
    tw = [torch.from_numpy(w) for w in weights]
    moe, rules = T.MoEConfig(e, k, f, cf), T.Rules(dp_size=dp)
    ty, taux = T._moe_ffn(tx, *tw, moe, rules)
    disp = T.moe_route(tx, tw[0], moe, rules)
    return (jy, jaux, info, combine), (ty, taux, disp)


def _ref_kept(info) -> set:
    """The reference's kept assignments as (group, token, expert, slot)."""
    sorted_e, pos, keep, tok = (np.asarray(a) for a in info[:4])
    g, n = sorted_e.shape
    grp = np.repeat(np.arange(g), n).reshape(g, n)
    return set(zip(grp[keep].tolist(), tok[keep].tolist(),
                   sorted_e[keep].tolist(), pos[keep].tolist()))


def _port_kept(r: T.MoEDispatch) -> set:
    g, tl, k = r.top_e.shape
    grp = torch.arange(g).view(g, 1, 1).expand(g, tl, k)
    tok = torch.arange(tl).view(1, tl, 1).expand(g, tl, k)
    keep = r.keep
    return set(zip(grp[keep].tolist(), tok[keep].tolist(),
                   r.top_e[keep].tolist(), r.slot[keep].tolist()))


def _min_margin(r: T.MoEDispatch, k: int) -> float:
    """Smallest gap between a token's k-th and (k+1)-th logit."""
    top = torch.sort(r.logits, dim=-1, descending=True).values
    return float((top[..., k - 1] - top[..., k]).min())


# (tokens, dp_size, capacity_factor): capacity 1.25 drops, 16 does not;
# 6 tokens on dp 4 fall back to 2 groups; 4 tokens are a decode batch
# (capacity 2 in one group, 1 in four)
CASES = [(64, 1, 1.25), (64, 2, 1.25), (64, 4, 1.25), (64, 1, 16.0),
         (64, 4, 16.0), (6, 4, 1.25), (4, 1, 1.25), (4, 4, 1.25)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,dp,cf", CASES)
def test_moe_ffn_matches_reference(monkeypatch, t, dp, cf, dtype):
    rng = np.random.default_rng(t * 100 + dp)
    x = rng.standard_normal((t, D)).astype(np.float32)
    (jy, jaux, info, _), (ty, taux, r) = _run_both(
        monkeypatch, x, _weights(rng), cf, dp, dtype)
    assert r.groups == T.moe_groups(t, dp) == np.asarray(info[0]).shape[0]
    assert r.capacity == T.moe_capacity(t // r.groups, T.MoEConfig(E, K, F,
                                                                     cf))
    assert _min_margin(r, K) > 1e-4
    kept = _port_kept(r)
    assert kept == _ref_kept(info)
    dropped = t * K - len(kept)
    if cf == 16.0:
        assert dropped == 0
    elif (t, dp) == (64, 4):
        assert dropped > 0          # the case exercises dropping
    np.testing.assert_array_equal(np.asarray(info[6]), r.top_e.numpy())
    ref = np.asarray(jy, np.float32)
    got = ty.float().numpy()
    assert ty.dtype == dtype and ty.shape == (t, D)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= BF16_RTOL * np.abs(ref).max()
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("t,dp,cf", [(64, 1, 1.25), (64, 4, 1.25),
                                     (64, 2, 16.0), (4, 1, 1.25)])
def test_moe_combine_bit_equal_bf16(monkeypatch, t, dp, cf):
    """The port's combine against the reference's own ``combine`` on the
    same bfloat16 expert outputs and dispatch: bit-equal."""
    rng = np.random.default_rng(7 + t + dp)
    x = rng.standard_normal((t, D)).astype(np.float32)
    (_, _, info, combine), (_, _, r) = _run_both(
        monkeypatch, x, _weights(rng), cf, dp, torch.bfloat16)
    g, cap = r.groups, r.capacity
    out = rng.standard_normal((g, E, cap, D)).astype(np.float32)
    jout = jnp.asarray(out).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax.vmap(combine))(jout, info).reshape(t, D)
                      .astype(jnp.float32))
    rows = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(
        torch.bfloat16).permute(1, 0, 2, 3).reshape(E * g * cap, D)
    got = T._moe_combine(rows, T._moe_rows(r), r)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_router_ties_go_to_the_lower_expert(monkeypatch):
    """Equal router columns give exactly equal probabilities: the lower
    expert ranks first, as ``lax.top_k`` ranks it. With a zero router every
    token picks experts 0..k-1, so expert 0's capacity drops the rest."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, D)).astype(np.float32)
    router, wg, wu, wd = _weights(rng)
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    for r_in in (router, np.zeros_like(router)):
        (jy, _, info, _), (ty, _, r) = _run_both(
            monkeypatch, x, (r_in, wg, wu, wd), 1.25, 1, torch.float32)
        np.testing.assert_array_equal(np.asarray(info[6]), r.top_e.numpy())
        assert _port_kept(r) == _ref_kept(info)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    assert (r.top_e == torch.arange(K)).all()
    assert int(r.keep.sum()) == 2 * r.capacity      # experts 0 and 1 full
    # among tied experts 2, 5, 6 the lower ones rank first wherever two of
    # them are picked
    tops = T.moe_route(torch.from_numpy(x), torch.from_numpy(router),
                       T.MoEConfig(E, K, F)).top_e.reshape(-1, K).tolist()
    tied = [p for p in tops if sum(e in (2, 5, 6) for e in p) == 2]
    assert tied and all(p == [2, 5] for p in tied)


def test_aux_loss_of_a_uniform_router_is_one():
    """A zero router: probabilities 1/E everywhere, every token's top-1 is
    expert 0, so aux = E * (1 * 1/E) = 1."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((12, D)).astype(np.float32))
    _, wg, wu, wd = (torch.from_numpy(w) for w in _weights(rng))
    _, aux = T._moe_ffn(x, torch.zeros(D, E), wg, wu, wd,
                        T.MoEConfig(E, K, F))
    assert float(aux) == pytest.approx(1.0, abs=1e-6)


def test_nonfinite_token_stays_in_its_own_row():
    """A non-finite token spreads to no other token: at capacity factor
    0.5 (t 16, d 8, E 4, top-2: many assignments drop, and each dropped
    one points at buffer row 0), with token 0 set to inf, the non-finite
    output rows are the reference's, token 0's alone (a dropped assignment
    is selected out of the sum, not multiplied by a zero weight)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    x[0] = np.inf
    weights = _weights(rng, e=4, d=8, f=12)
    jy, _ = jax.jit(lambda *a: J._moe_ffn(*a, J.MoEConfig(4, 2, 12, 0.5),
                                          J.Rules()))(
        jnp.asarray(x), *(jnp.asarray(w) for w in weights))
    moe = T.MoEConfig(4, 2, 12, 0.5)
    tx, tw = torch.from_numpy(x), [torch.from_numpy(w) for w in weights]
    ty, _ = T._moe_ffn(tx, *tw, moe)
    want = set(np.nonzero(~np.isfinite(np.asarray(jy)).all(-1))[0].tolist())
    got = set(torch.nonzero(~torch.isfinite(ty).all(-1))[:, 0].tolist())
    assert want == {0}
    assert got == want
    assert not bool(T.moe_route(tx, tw[0], moe).keep.all())   # drops happen


def _moe_model(cf=16.0):
    return T.TransformerConfig(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
        moe=T.MoEConfig(4, 2, 16, capacity_factor=cf),
        compute_dtype=torch.float32, remat=False)


def test_moe_group_count_invariance_no_drop():
    """With no-drop capacity the MoE model's hidden states and aux loss are
    the same for 1 and 4 dispatch groups (group-wise capacity changes only
    which assignments drop); at capacity 1.25 the groups drop other ones."""
    cfg = _moe_model()
    params = T.init_params(cfg, torch.Generator().manual_seed(7))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 64, (4, 8)).astype(np.int32))
    h1, a1, _ = T.forward(cfg, params, toks, T.Rules(dp_size=1))
    h4, a4, _ = T.forward(cfg, params, toks, T.Rules(dp_size=4))
    torch.testing.assert_close(h4, h1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a4, a1, rtol=1e-6, atol=1e-6)
    assert float(a1) > 0


@pytest.mark.parametrize("dp", [1, 4])
def test_moe_forward_matches_reference(dp):
    """A one-layer MoE model, the reference's parameters carried over by
    the bridge: hidden states within 2e-4 (the attention bound of
    tests/test_torch_transformer.py) and the aux loss within 1e-6, at
    capacity 1.25 (drops) on 1 and 4 dispatch groups."""
    tcfg = _moe_model(cf=1.25)
    jcfg = J.TransformerConfig(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
        moe=J.MoEConfig(4, 2, 16, capacity_factor=1.25),
        compute_dtype=jnp.float32, remat=False)
    jp = J.init_params(jcfg, jax.random.PRNGKey(5))
    tp = bridge.transformer_params_from_arrays(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert set(tp["layers"]) >= {"router", "w_gate", "w_up", "w_down"}
    toks = np.random.default_rng(9).integers(0, 64, (4, 16)).astype(np.int32)
    jh, ja, _ = J.forward(jcfg, jp, jnp.asarray(toks), J.Rules(dp_size=dp))
    th, ta, _ = T.forward(tcfg, tp, torch.from_numpy(toks),
                          T.Rules(dp_size=dp))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_moe_smoke_prefill_bf16_matches_reference(monkeypatch):
    """granite-moe's smoke model in bfloat16 compute, prefill and one
    decode step: logits within 2% of the reference's max |logit|, the
    bound tests/test_torch_bf16.py holds bfloat16 models to."""
    arch_id = "granite-moe-1b-a400m"
    from repro.configs import get_arch as jax_get_arch
    jcfg = dataclasses.replace(jax_get_arch(arch_id).smoke(),
                               compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch(arch_id).smoke(),
                               compute_dtype=torch.bfloat16)
    jp = J.init_params(jcfg, jax.random.PRNGKey(2))
    tp = bridge.transformer_params_from_arrays(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(J, "jnp", _Float32Dots())
    toks = np.random.default_rng(10).integers(1, jcfg.vocab, (2, 12)).astype(
        np.int32)
    jl, jc = jax.jit(J.prefill, static_argnums=(0, 3))(
        jcfg, jp, jnp.asarray(toks), 16)
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(toks), 16)
    nxt = np.asarray(jl[:, -1].argmax(-1))[:, None].astype(np.int32)
    jd, _ = jax.jit(J.decode_step, static_argnums=(0,))(
        jcfg, jp, jnp.asarray(nxt), jc, 12)
    td, _ = T.decode_step(tcfg, tp, torch.from_numpy(nxt), tc, 12)
    for ref, got in ((jl, tl), (jd, td)):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
