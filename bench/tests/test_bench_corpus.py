"""The generator: the same seed gives the same corpus, bit for bit, and a
corpus has its configuration's postings per doc and expansion share."""
import pytest
import torch

from bench.corpus import make_corpus
from bench.tests.tiny import tiny_config

CONFIGS = ("splade-msmarco-1m", "unicoil-msmarco-1m")
FIELDS = ("bm25_terms", "bm25_docs", "bm25_tfs", "doc_lens", "l_indptr",
          "l_docs", "l_weights", "q_terms", "q_lens", "q_weights_l")


@pytest.fixture
def one_thread():
    """torch's CPU log and exp take other vector paths as threads split a
    tensor (a last-bit change that log(1 + x) at small x amplifies); one
    thread fixes the split, as a card's kernels are fixed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_corpus(name, one_thread):
    cfg = tiny_config(name, n_docs=1 << 12)
    cfg["queries"]["n"] = 32
    seed = 2 ** 31 + 12345        # beyond 32 signed bits
    a, b = make_corpus(cfg, seed, "cpu"), make_corpus(cfg, seed, "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c = make_corpus(cfg, seed + 1, "cpu")
    assert not torch.equal(a.l_weights[:100], c.l_weights[:100])


@pytest.mark.parametrize("name", CONFIGS)
def test_postings_per_doc_and_expansion_share(name):
    cfg = tiny_config(name, n_docs=1 << 14)
    cfg["queries"]["n"] = 64
    c = make_corpus(cfg, 7, "cpu")
    n = c.n_docs
    key_b = c.bm25_terms * n + c.bm25_docs
    terms = torch.repeat_interleave(torch.arange(c.n_terms),
                                    torch.diff(c.l_indptr))
    key_l = terms * n + c.l_docs.long()
    merged = torch.unique(torch.cat([key_b, key_l])).numel() / n
    share = (~torch.isin(key_l, key_b)).float().mean().item()
    want = cfg["expect"]
    assert merged == pytest.approx(want["postings_per_doc"], rel=0.05)
    assert share == pytest.approx(want["expansion_share"], abs=0.02)
    # every learned list sorted and free of repeats; tfs and lens as drawn
    assert bool((torch.diff(key_l) > 0).all())
    assert bool((torch.diff(key_b) > 0).all())
    assert bool((c.bm25_tfs >= 1).all()) and bool((c.doc_lens >= 1).all())
    q = cfg["queries"]["terms"]
    assert int(c.q_lens.min()) >= q["min"] and int(c.q_lens.max()) <= q["max"]
    live = torch.arange(c.q_terms.shape[1])[None] < c.q_lens[:, None]
    assert bool((c.q_weights_l[live] >= 1).all())
    assert bool((c.q_weights_l[~live] == 0).all())
    for row, ln in zip(c.q_terms, c.q_lens):
        assert len(set(row[:ln].tolist())) == int(ln)
