"""K1's work is counted from the index and the schedule: live postings
only, each read once, padding excluded, whatever the chunk's arguments
look like."""
import numpy as np
import pytest
import torch

from bench.peaks import peaks
from bench.roofline import k1_counts, k1_work, least_time_s, live_postings


def _padded(run_lengths, pad_len):
    """A chunk's offsets as K1 takes them: each run padded with -1 to
    ``pad_len``."""
    offs = np.full(run_lengths.shape + (pad_len,), -1)
    for idx in np.ndindex(run_lengths.shape):
        offs[idx][:run_lengths[idx]] = np.arange(run_lengths[idx])
    return offs


def test_hand_counted_chunk():
    # 2 queries x 3 tiles x 2 terms; query 1's second tile skipped
    runs = np.array([[[3, 0], [1, 4], [0, 0]],
                     [[2, 2], [5, 1], [0, 7]]])
    skip = np.array([[False, False, False], [False, True, False]])
    assert live_postings(runs, skip).tolist() == [3 + 1 + 4, 2 + 2 + 7]
    w = k1_work(postings=19, tile_terms=5 * 2, tiles=5, tile_size=2048)
    assert w["bytes"] == 12 * 19 + 8 * 10 + 20 * 2048 * 5
    assert w["ops"] == 4 * 19 + 9 * 2048 * 5


def test_hand_counted_rows_leave_out_pad_slots():
    # 2 rows x 3 tiles (visit order) x 3 slots; row 0's last slot pads it
    runs = torch.tensor([[[3, 0, 9], [1, 4, 9], [2, 2, 9]],
                         [[2, 2, 5], [5, 1, 6], [7, 7, 7]]])
    real = torch.tensor([[True, True, False], [True, True, True]])
    visited = torch.tensor([2, 1])
    c = k1_counts(runs, real, visited)
    assert c["postings"].tolist() == [3 + 0 + 1 + 4, 2 + 2 + 5]
    assert c["pad_postings"].tolist() == [9 + 9, 0]
    assert c["tile_terms"].tolist() == [2 * 2, 1 * 3]
    assert c["tiles"].tolist() == [2, 1]
    assert c["postings"].dtype == torch.int64


def test_count_from_the_schedule_matches_the_replay():
    """The count that reads the program's visited tiles against the
    replay's own count of the tiles it scored, row by row, pad slots left
    out: on the tiny corpus of the tests, at a width that pads."""
    import numpy as np
    from bench.reference import twogti
    from bench.runners.sparse_retrieval import _rows
    from bench.tests.tiny import tiny_config
    from bench import corpus as gen
    cfg = tiny_config("splade-msmarco-1m", n_docs=1 << 12, n_terms=512)
    cfg["queries"]["n"] = 16
    c = gen.make_corpus(cfg, 11, "cpu")
    m = twogti.merge(c)
    lens = c.q_lens.tolist()
    x = {"terms": [c.q_terms[q, :n].numpy() for q, n in enumerate(lens)],
         "weights_b": [np.ones(n, np.float32) for n in lens],
         "weights_l": [c.q_weights_l[q, :n].numpy()
                       for q, n in enumerate(lens)]}
    (_, rows), = _rows([(0, x, r) for r in range(len(lens))], "cpu")
    assert not bool(rows.real.all())
    ref = twogti.replay(m, rows, cfg["pruning"], 10, 256)
    sc = twogti.schedule(m, rows, cfg["pruning"], 256)
    got = k1_counts(twogti.visit_order_runs(m, sc, 256), sc.real,
                    ref.tiles_visited)
    assert torch.equal(got["postings"], ref.live_postings)
    assert torch.equal(got["postings"] + got["pad_postings"],
                       ref.postings_touched)
    assert int(got["pad_postings"].sum()) > 0


@pytest.mark.parametrize("pad_len", [8, 16, 64])
def test_same_count_for_any_layout(pad_len):
    rng = np.random.default_rng(0)
    runs = rng.integers(0, 8, (4, 8, 5))
    skip = rng.random((4, 8)) < 0.3
    want = live_postings(runs, skip).sum()
    offs = _padded(runs, pad_len)          # K1's padded arguments
    from_args = int(((offs >= 0) & ~skip[..., None, None]).sum())
    assert from_args == want
    # the terms in another order, the tiles in another order
    perm_t, perm_c = rng.permutation(5), rng.permutation(8)
    assert live_postings(runs[:, perm_c][..., perm_t],
                         skip[:, perm_c]).sum() == want
    assert live_postings(torch.from_numpy(runs),
                         torch.from_numpy(skip)).sum().item() == want


def test_least_time_names_its_bound():
    peak = peaks("NVIDIA H100 80GB HBM3")
    t, by = least_time_s({"bytes": 3.35e12, "ops": 1.0}, peak)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = least_time_s({"bytes": 1.0, "ops": 67e12 * 2}, peak)
    assert (t, by) == (pytest.approx(2.0), "ops")
    assert peaks("cpu") is None
