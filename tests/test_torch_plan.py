"""Every planner function of the port against the JAX package's.

The reference maps one query at a time (vmapped here); the port plans the
batch at once. All outputs must be bit-identical: the port adds the query
terms' bounds left to right in float32, the order XLA uses on the CPU, and
sorts stably as ``jnp.argsort`` does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as jax_build_index
from repro.core import plan as jp
from repro_torch import bridge
from repro_torch.core import plan as tp

COEFS = [(1.0, 0.3), (0.2, 0.2), (0.0, 0.0), (1.0, 0.0), (0.7, 0.05)]


@pytest.fixture(scope="module", params=[64, 256], ids=["tile64", "tile256"])
def indexes(request, small_corpus):
    jidx = jax_build_index(small_corpus.merged("scaled"),
                           tile_size=request.param)
    fields = {f.name: (None if getattr(jidx, f.name) is None
                       else np.asarray(getattr(jidx, f.name)))
              for f in dataclasses.fields(jidx)}
    return small_corpus, jidx, bridge.index_from_arrays(fields, device="cpu")


def _plans(corpus, jidx, tidx, alpha):
    q = (corpus.queries, corpus.q_weights_b, corpus.q_weights_l)
    jplan = jax.vmap(jp.plan_query, in_axes=(0, 0, 0, None, None, None))(
        *(jnp.asarray(a) for a in q), jidx.sigma_b, jidx.sigma_l,
        jnp.float32(alpha))
    tplan = tp.plan_query(*(torch.from_numpy(a) for a in q), tidx.sigma_b,
                          tidx.sigma_l, float(np.float32(alpha)))
    return jplan, tplan


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


@pytest.mark.parametrize("alpha,beta", COEFS)
def test_plan_query_and_tile_bounds(indexes, alpha, beta):
    corpus, jidx, tidx = indexes
    jplan, tplan = _plans(corpus, jidx, tidx, alpha)
    for name, a, b in zip(jp.QueryPlan._fields, jplan, tplan):
        _eq(a, b, name)
    ub_j = jax.vmap(jp.tile_upper_bounds, in_axes=(0, None, None, None))(
        jplan, jidx.tile_max_b, jidx.tile_max_l, jnp.float32(alpha))
    _eq(ub_j, tp.tile_upper_bounds(tplan, tidx.tile_max_b, tidx.tile_max_l,
                                   float(np.float32(alpha))), "ub")
    for schedule in ("docid", "impact"):
        order_j = jax.vmap(lambda p: jp.tile_schedule(
            p, jidx.tile_max_b, jidx.tile_max_l, jnp.float32(alpha),
            jidx.n_tiles, schedule))(jplan)
        order_t = tp.tile_schedule(tplan, tidx.tile_max_b, tidx.tile_max_l,
                                   float(np.float32(alpha)), tidx.n_tiles,
                                   schedule)
        _eq(order_j, order_t, schedule)
        assert order_t.dtype == torch.int32


@pytest.mark.parametrize("n_real", [None, 3])
@pytest.mark.parametrize("chunk_tiles", [1, 3, 8])
def test_chunk_schedule(indexes, chunk_tiles, n_real):
    corpus, jidx, tidx = indexes
    jplan, tplan = _plans(corpus, jidx, tidx, 1.0)
    js = jax.vmap(lambda p: jp.chunk_schedule(
        p, jidx.tile_max_b, jidx.tile_max_l, jnp.float32(1.0), jidx.n_tiles,
        chunk_tiles, n_real))(jplan)
    ts = tp.chunk_schedule(tplan, tidx.tile_max_b, tidx.tile_max_l, 1.0,
                           tidx.n_tiles, chunk_tiles, n_real)
    _eq(js.chunks, ts.chunks, "chunks")
    _eq(js.chunk_ub, ts.chunk_ub, "chunk_ub")
    # a permutation of all tiles plus sentinel padding, bounds descending
    real = ts.chunks[ts.chunks < tidx.n_tiles]
    assert real.numel() == corpus.queries.shape[0] * tidx.n_tiles
    assert (ts.chunk_ub[:, 1:] <= ts.chunk_ub[:, :-1]).all()


@pytest.mark.parametrize("bound_mode", ["list", "tile"])
@pytest.mark.parametrize("alpha,beta", COEFS)
def test_term_bounds_partition_and_freeze(indexes, alpha, beta, bound_mode):
    corpus, jidx, tidx = indexes
    jplan, tplan = _plans(corpus, jidx, tidx, alpha)
    b = corpus.queries.shape[0]
    rng = np.random.default_rng(b)
    # one tile per row, and a chunk of tiles per row including the
    # sentinel id n_tiles (clamped by both packages)
    tiles = rng.integers(0, jidx.n_tiles, b).astype(np.int32)
    chunk = rng.integers(0, jidx.n_tiles + 1, (b, 3)).astype(np.int32)
    a32, b32 = float(np.float32(alpha)), float(np.float32(beta))

    def jax_bounds(plan, t):
        return jp.term_bounds(plan, jidx.tile_max_b, jidx.tile_max_l, t,
                              jnp.float32(alpha), jnp.float32(beta),
                              bound_mode)
    jb1 = jax.vmap(jax_bounds)(jplan, jnp.asarray(tiles))
    tb1 = tp.term_bounds(tplan, tidx.tile_max_b, tidx.tile_max_l,
                         torch.from_numpy(tiles), a32, b32, bound_mode)
    jbc = jax.vmap(jax.vmap(jax_bounds, in_axes=(None, 0)))(
        jplan, jnp.asarray(chunk))
    tbc = tp.term_bounds(tplan, tidx.tile_max_b, tidx.tile_max_l,
                         torch.from_numpy(chunk), a32, b32, bound_mode)
    for name, a, t in zip(("m_alpha", "m_beta", "ub_gl"), jb1, tb1):
        _eq(a, t, name)
    for name, a, t in zip(("m_alpha", "m_beta", "ub_gl"), jbc, tbc):
        _eq(a, t, "chunk " + name)

    # thresholds straddling the prefix sums, -inf included
    th = np.concatenate([[-np.inf], rng.random(b - 1) * 6]).astype(np.float32)
    ess_j = jax.vmap(jp.essential_terms)(jb1[0], jnp.asarray(th))
    _eq(ess_j, tp.essential_terms(tb1[0], torch.from_numpy(th)), "essential")
    _eq(jax.vmap(jp.freeze_bounds)(jb1[1]), tp.freeze_bounds(tb1[1]),
        "prefix_beta")
