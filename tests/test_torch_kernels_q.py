"""The decode-in-kernel scorers' plain PyTorch versions against the Pallas
kernels ``guided_score_tile_q`` / ``guided_score_chunk_q`` (interpret
mode, as tests/test_kernels.py runs them).

Inputs are real raw rows: the reference's ``gather_tile_q_raw`` on a small
compressed index (tile size 128), with terms picked so that a row holds no
posting, one posting, or a tile's longest runs; planner inputs come from a
seed. The reference carries the codes as f32, the port as uint8: the same
integers. Masks (rows 3-4) and postings per slot (row 5) identical; rows
0-2 within rtol/atol 1e-5 (XLA contracts the combines into fused
multiply-adds, the port rounds each product). The CUDA kernels are held
to the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import compress_index as jax_compress
from repro.index.compressed import gather_tile_q_raw as jax_gather_raw
from repro.kernels.guided_score import guided_score_chunk_q as jax_chunk_q
from repro.kernels.guided_score import guided_score_tile_q as jax_tile_q
from repro_torch.kernels import guided_score as gs

TILE = 128
COEFS = (1.0, 0.3, 0.05)


@pytest.fixture(scope="module")
def index(small_corpus):
    return jax_compress(small_corpus.merged("scaled"), tile_size=TILE)


# tiles of the fixture's index where some term has no posting and some
# term exactly one
EDGE_TILES = (0, 9)


def _terms(index, tile, nq, rng):
    """``nq`` term ids for ``tile``: its shortest run (empty on
    ``EDGE_TILES``), a run of one posting (or its shortest nonempty run),
    then the tile's longest runs and random terms."""
    cnt = np.diff(np.asarray(index.tile_ptr), axis=1)[
        :, min(tile, index.n_tiles - 1)]
    short = np.argsort(np.where(cnt > 0, cnt, cnt.max() + 1), kind="stable")
    longest = np.argsort(-cnt, kind="stable")[:(nq - 2) // 2]
    rand = rng.choice(index.n_terms, nq - 2 - len(longest), replace=False)
    return np.concatenate([[np.argmin(cnt), short[0]], longest,
                           rand]).astype(np.int32)


def _raw(index, terms, tile):
    """The reference's raw rows, and the port's (uint8 codes)."""
    ref = jax_gather_raw(index.gather_arrays(), jnp.asarray(terms), tile,
                         pad_len=index.pad_len)
    words, qb, ql, meta_i, meta_f = (np.asarray(a) for a in ref)
    port = (words, qb.astype(np.uint8), ql.astype(np.uint8), meta_i, meta_f)
    return ref, port


def _planner(rng, lead, nq):
    qw = (rng.random((2,) + lead[:1] + (nq,)) * 2).astype(np.float32)
    qw[..., -1] = 0.0                                   # a padded term
    ess = (rng.random(lead + (nq,)) < 0.5).astype(np.float32)
    pbeta = np.cumsum(rng.random(lead + (nq,)), -1).astype(np.float32)
    return qw[0], qw[1], ess, pbeta


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rows_match(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape
    np.testing.assert_array_equal(ref[..., 3:, :], port[..., 3:, :])
    np.testing.assert_allclose(ref[..., :3, :], port[..., :3, :],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile,nq,block_s,th_lo", [
    (0, 8, 128, 0.5), (9, 5, 64, 2.0), (11, 16, 32, -np.inf),
    (16, 6, 128, 0.5)],                                 # 16 = sentinel tile
    ids=["tile0", "tile9-nq5", "tile11-nq16", "sentinel"])
def test_tile_q_plain_matches_pallas(index, tile, nq, block_s, th_lo):
    rng = np.random.default_rng(tile * 10 + nq)
    terms = _terms(index, tile, nq, rng)
    ref_rows, rows = _raw(index, terms, tile)
    qwb, qwl, ess, pbeta = _planner(rng, (), nq)
    ref = jax_tile_q(*ref_rows, jnp.asarray(qwb), jnp.asarray(qwl),
                     jnp.asarray(ess), jnp.asarray(pbeta),
                     jnp.float32(th_lo), *(jnp.float32(c) for c in COEFS),
                     tile_size=TILE, pad_len=index.pad_len, block_s=block_s)
    port = gs.guided_score_tile_q(
        *(_t(a[None]) for a in rows + (qwb, qwl, ess, pbeta)),
        torch.tensor([th_lo], dtype=torch.float32), *COEFS, tile_size=TILE)
    _assert_rows_match(ref, port[0])
    cnt = rows[3][0]
    assert port[0, 5].sum() == cnt.sum()                # every posting counted
    if tile >= index.n_tiles:
        assert (cnt == 0).all() and (port == 0).all()
    elif tile in EDGE_TILES:
        assert cnt[0] == 0 and cnt[1] == 1


@pytest.mark.parametrize("n_chunk,nq,th", [(4, 6, (1.0, 0.2)),
                                           (3, 9, (-np.inf, 3.0))])
def test_chunk_q_plain_matches_pallas(index, n_chunk, nq, th):
    """Batched over queries: each row's chunk equals the reference's
    per-query chunk call; a chunk holds live, skipped and sentinel tiles,
    and skipped tiles publish six zero rows."""
    rng = np.random.default_rng(n_chunk * 100 + nq)
    b = 2
    tiles = rng.choice(index.n_tiles, (b, n_chunk), replace=False)
    tiles[:, 0] = EDGE_TILES
    tiles[:, -1] = index.n_tiles
    terms = [_terms(index, int(tiles[r, 0]), nq, rng) for r in range(b)]
    raws = [[_raw(index, terms[r], int(t)) for t in tiles[r]]
            for r in range(b)]
    port_rows = [np.stack([np.stack([raw[1][j] for raw in row])
                           for row in raws]) for j in range(5)]
    qwb, qwl, ess, pbeta = _planner(rng, (b, n_chunk), nq)
    skip = (rng.random((b, n_chunk)) < 0.3).astype(np.int32)
    skip[:, -1] = 1                                     # the sentinel
    skip[:, 0] = 0
    th = np.asarray(th, np.float32)
    port = gs.guided_score_chunk_q(
        *(_t(a) for a in port_rows + [qwb, qwl, ess, pbeta, skip, th]),
        *COEFS, tile_size=TILE)
    assert port.shape == (b, n_chunk, 6, TILE)
    for r in range(b):
        ref_rows = [jnp.stack([raw[0][j] for raw in raws[r]])
                    for j in range(5)]
        ref = jax_chunk_q(*ref_rows, jnp.asarray(qwb[r]),
                          jnp.asarray(qwl[r]), jnp.asarray(ess[r]),
                          jnp.asarray(pbeta[r]), jnp.asarray(skip[r]),
                          jnp.float32(th[r]),
                          *(jnp.float32(c) for c in COEFS), tile_size=TILE,
                          pad_len=index.pad_len, block_s=64)
        _assert_rows_match(ref, port[r])
        assert (port[r][skip[r] != 0] == 0).all()


def test_chunk_q_all_skipped_is_zero(index):
    rng = np.random.default_rng(0)
    terms = _terms(index, 2, 4, rng)
    ref_rows, rows = _raw(index, terms, 2)
    port = gs.guided_score_chunk_q(
        *(_t(np.stack([np.stack([a, a])] * 2)) for a in rows),
        torch.ones(2, 4), torch.ones(2, 4), torch.ones(2, 2, 4),
        torch.ones(2, 2, 4), torch.ones(2, 2, dtype=torch.int32),
        torch.zeros(2), *COEFS, tile_size=TILE)
    ref = jax_chunk_q(*(jnp.stack([a, a]) for a in ref_rows),
                      jnp.ones(4), jnp.ones(4), jnp.ones((2, 4)),
                      jnp.ones((2, 4)), jnp.ones(2, jnp.int32),
                      jnp.float32(0.0), *(jnp.float32(c) for c in COEFS),
                      tile_size=TILE, pad_len=index.pad_len)
    np.testing.assert_array_equal(np.asarray(ref), 0.0)
    np.testing.assert_array_equal(port.numpy(), 0.0)


def test_q_cpu_tensors_run_the_plain_version_uncounted(index):
    """Dispatch is by device: CPU tensors never reach the kernels or their
    launch counts; the chunk form equals the tile form on a live tile, and
    the plain scorer equals the fp32 plain scorer on the decoded rows."""
    gs.reset_launches()
    rng = np.random.default_rng(1)
    _, rows = _raw(index, _terms(index, 3, 6, rng), 3)
    qwb, qwl, ess, pbeta = _planner(rng, (1,), 6)
    th = torch.tensor([0.5])
    rows1 = [_t(a[None]) for a in rows]
    plan = [_t(a) for a in (qwb, qwl, ess, pbeta)]
    tile = gs.guided_score_tile_q(*rows1, *plan, th, *COEFS, tile_size=TILE)
    chunk = gs.guided_score_chunk_q(
        *(r[:, None] for r in rows1), *plan[:2], plan[2][:, None],
        plan[3][:, None], torch.zeros(1, 1, dtype=torch.int32), th, *COEFS,
        tile_size=TILE)
    torch.testing.assert_close(tile, chunk[:, 0], rtol=0, atol=0)
    offs, wb, wl = gs.decode_rows(*rows1, plan[0], plan[1])
    fp32 = gs.guided_score_tile(offs, wb, wl, *plan[2:], th, *COEFS,
                                tile_size=TILE)
    torch.testing.assert_close(tile, fp32, rtol=0, atol=0)
    assert all(fn.launches == 0 for fn in gs.KERNELS)
    with pytest.raises(ValueError, match="device"):
        gs.guided_score_tile_q(rows1[0].to("meta"), *rows1[1:], *plan, th,
                               *COEFS, tile_size=TILE)
