"""The reference against ``Retriever.search`` on a tiny corpus on the CPU
(the kernels' plain versions), the control that has to fail, and the
faults a run has to catch."""
import json

import numpy as np
import pytest

from bench.control import readings
from bench.run import run_cell
from bench.tests.tiny import tiny_root

SEED = 2 ** 31 + 99
CELLS = ("splade.b512.k1000", "unicoil.b512.k10", "splade.b512.k10",
         "unicoil.b512.k1000")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=SEED):
    return run_cell(cell, seed, 0.3, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]
    for c in r["checks"].values():
        assert c["value"] <= 1e-6
    check = r["info"]["check"]
    assert check["rows"] == min(64, 16 * r["info"]["searches"])
    assert check["stats_differ"] == {"tiles_visited": 0,
                                     "postings_touched": 0,
                                     "k1_postings": 0}


@pytest.mark.parametrize("config", ("splade-msmarco-1m",
                                    "unicoil-msmarco-1m"))
def test_bfloat16_control_fails(root, config):
    limits = {c: json.loads((root / "bench" / "checks"
                             / f"{c}.json").read_text())["limits"]
              for c in CELLS}
    outs = list(readings(config, [SEED], {SEED},
                         {"b512.k10": 4, "b512.k1000": 4}, device="cpu",
                         root=root))
    assert len(outs) == 2
    for out in outs:
        lim = limits[out["cell"]]
        prog, ctl = out["program"]["numbers"], out["control_bf16"]["numbers"]
        assert all(prog[n] <= lim[n] for n in lim)
        assert any(ctl[n] > lim[n] for n in lim)
        assert all(ctl[n] >= 100 * max(prog[n], 1e-9) for n in lim)


def _unchanged_step(ctx, carry, tiles_chunk, n_valid, th_floor=None):
    return carry


def _half_batch(fn):
    def search(index, q_terms, qw_b, qw_l, params, **kw):
        half = len(q_terms) // 2
        res = fn(index, q_terms[:half], qw_b[:half], qw_l[:half], params,
                 **kw)
        pad = len(q_terms) - half

        def grow(a, fill):
            return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                              a.dtype)])
        res.ids, res.scores = grow(res.ids, -1), grow(res.scores, -np.inf)
        res.stats = {k: grow(v, 0) for k, v in res.stats.items()}
        return res
    return search


def _altered_answer(fn):
    def search(*args, **kw):
        res = fn(*args, **kw)
        res.ids = res.ids.copy()
        res.ids[:, 0] = (res.ids[:, 0] + 1) % 1024
        return res
    return search


def _few_rows_one_deeper(fn):
    """Rows r % 8 == 0 miss their top doc: they answer with ranks 2..k+1
    of a search one deeper, each entry still a score 2GTI can give."""
    def search(*args, k, **kw):
        res = fn(*args, k=k, **kw)
        deeper = fn(*args, k=k + 1, **kw)
        res.ids, res.scores = res.ids.copy(), res.scores.copy()
        res.ids[::8] = deeper.ids[::8, 1:]
        res.scores[::8] = deeper.scores[::8, 1:]
        return res
    return search


def _early_exit(fn):
    def loop(advance, chunk_ub, carry, factor, th_floor=None):
        return fn(advance, chunk_ub[:, :1], carry, factor, th_floor)
    return loop


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered_answer", "early_exit"])
def test_a_broken_timed_path_reads_incorrect(root, monkeypatch, fault):
    from repro_torch.core import traversal
    from repro_torch.retrieval import engines
    if fault == "state_unchanged":
        monkeypatch.setattr(traversal, "_chunk_step_fused", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(engines, "retrieve_batched",
                            _half_batch(engines.retrieve_batched))
    elif fault == "altered_answer":
        monkeypatch.setattr(engines, "retrieve_batched",
                            _altered_answer(engines.retrieve_batched))
    else:
        monkeypatch.setattr(traversal, "_chunk_while",
                            _early_exit(traversal._chunk_while))
    r = _run(root, "splade.b512.k1000")
    assert not r["correct"], r["checks"]


def test_a_few_wrong_rows_read_incorrect(root, monkeypatch):
    """One row in eight answers without its top doc, every entry valid:
    ``valid_gap`` passes it, and ``rank_gap``, the widest row, fails it."""
    from repro_torch.retrieval import engines
    monkeypatch.setattr(engines, "retrieve_batched",
                        _few_rows_one_deeper(engines.retrieve_batched))
    r = _run(root, "unicoil.b512.k10")
    assert not r["correct"], r["checks"]
    assert r["checks"]["valid_gap"]["value"] <= \
        r["checks"]["valid_gap"]["limit"]
    assert r["checks"]["rank_gap"]["value"] > r["checks"]["rank_gap"]["limit"]
