"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test skips (the decision is
made in the ``cuda`` fixture, at run time). This file imports neither JAX
nor the reference package, so it also runs where only the port's
dependencies exist:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.kernels import guided_score as gs
from repro_torch.retrieval import Retriever

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rng, lead, nq, p, tile_size):
    n = int(np.prod(lead))
    offs = np.full((n, nq, p), -1, np.int32)
    for r in range(n):
        for i in range(nq):
            cnt = int(rng.integers(0, min(p, tile_size) + 1))
            offs[r, i, :cnt] = np.sort(rng.choice(tile_size, cnt,
                                                  replace=False))
    wb = (rng.random(offs.shape) * 3).astype(np.float32) * (offs >= 0)
    wl = (rng.random(offs.shape) * 5).astype(np.float32) * (offs >= 0)
    ess = (rng.random((n, nq)) < 0.5).astype(np.float32)
    pb = np.cumsum(rng.random((n, nq)), -1).astype(np.float32)
    shapes = (lead + (nq, p),) * 3 + (lead + (nq,),) * 2
    return [torch.from_numpy(a).reshape(s)
            for a, s in zip((offs, wb, wl, ess, pb), shapes)]


@pytest.mark.parametrize("b,c,nq,p,s", [
    (3, 4, 5, 96, 384), (2, 3, 16, 2048, 2048), (2, 2, 64, 128, 1024),
    (4, 2, 7, 300, 1000)])
def test_kernels_equal_plain_on_card(cuda, b, c, nq, p, s):
    """Masks identical and scores bit-equal: the kernel rounds every
    product and sum as the plain version does (no contracted FMAs)."""
    rng = np.random.default_rng(b * 100 + nq)
    offs, wb, wl, ess, pb = (t.to(cuda) for t in _inputs(rng, (b, c), nq,
                                                          p, s))
    skip = torch.from_numpy((rng.random((b, c)) < 0.4).astype(np.int32)).to(
        cuda)
    th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(cuda)
    args = (offs, wb, wl, ess, pb, skip, th, 0.7, 0.2, 0.05)
    torch.testing.assert_close(gs.guided_score_chunk(*args, tile_size=s),
                               gs.guided_score_chunk_plain(*args,
                                                           tile_size=s),
                               rtol=0, atol=0)
    targs = (offs[:, 0].contiguous(), wb[:, 0].contiguous(),
             wl[:, 0].contiguous(), ess[:, 0].contiguous(),
             pb[:, 0].contiguous(), th, 1.0, 0.3, 0.05)
    torch.testing.assert_close(gs.guided_score_tile(*targs, tile_size=s),
                               gs.guided_score_tile_plain(*targs,
                                                          tile_size=s),
                               rtol=0, atol=0)
    torch.cuda.synchronize()


def test_wrappers_validate_and_count(cuda):
    rng = np.random.default_rng(0)
    offs, wb, wl, ess, pb = (t.to(cuda) for t in _inputs(rng, (2,), 4, 32,
                                                          256))
    th = torch.zeros(2, device=cuda)
    gs.reset_launches()
    gs.guided_score_tile(offs, wb, wl, ess, pb, th, 1.0, 0.3, 0.05,
                         tile_size=256)
    assert gs.guided_score_tile.launches == 1
    assert gs.guided_score_chunk.launches == 0
    with pytest.raises(ValueError, match="wb"):
        gs.guided_score_tile(offs, wb.double(), wl, ess, pb, th, 1.0, 0.3,
                             0.05, tile_size=256)
    with pytest.raises(ValueError, match="contiguous"):
        gs.guided_score_tile(offs, wb, wl.transpose(1, 2).contiguous()
                             .transpose(1, 2), ess, pb, th, 1.0, 0.3, 0.05,
                             tile_size=256)
    with pytest.raises(ValueError, match="th_lo"):
        gs.guided_score_tile(offs, wb, wl, ess, pb, th.cpu(), 1.0, 0.3,
                             0.05, tile_size=256)
    assert gs.guided_score_tile.launches == 1


def test_search_on_card_matches_cpu(cuda):
    corpus = make_corpus("splade_like", n_docs=8192, n_terms=2048,
                         n_queries=16, n_q_terms=8, avg_doc_terms=24, seed=2)
    merged = corpus.merged("scaled")
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l)
    gpu = build_index(merged, tile_size=512)            # device="cuda"
    cpu = build_index(merged, tile_size=512, device="cpu")
    for traversal in ("chunked_fused", "chunked"):
        gs.reset_launches()
        on_card = Retriever.open(gpu, twolevel.fast(), engine="kernel",
                                 traversal=traversal).search(**q, k=10)
        launched = gs.guided_score_chunk.launches + \
            gs.guided_score_tile.launches
        assert launched > 0
        on_cpu = Retriever.open(cpu, twolevel.fast(), engine="kernel",
                                traversal=traversal,
                                device="cpu").search(**q, k=10)
        np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                                   rtol=1e-6)
        for key in ("tiles_visited", "docs_survived", "chunks_dispatched"):
            np.testing.assert_array_equal(on_card.stats[key],
                                          on_cpu.stats[key])
