"""TREC-format qrels / run-file interchange.

The synthetic harness carries judgments as in-memory dicts, but real
collections (MS MARCO, BEIR) ship them as TREC text files; this module
is the bridge so the same ``evaluate_ranking`` scores either.
Formats (whitespace-separated, one judgment/result per line):

    qrels:  qid  iteration  docid  grade
    run:    qid  Q0         docid  rank  score  tag

Ids are kept as strings (TREC ids are opaque tokens like ``MARCO_1234``)
and mapped to dense integer indices on load, so the numeric metric
kernels in ``core.metrics`` apply unchanged. Grades <= 0 lines are kept
in the qrels mapping as explicit non-relevant judgments (standard TREC
practice) but contribute zero gain.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .harness import evaluate_ranking


@dataclasses.dataclass
class TrecQrels:
    """Graded judgments keyed by string qid/docid, plus the dense-int
    view the metric kernels consume."""
    gains: dict[str, dict[str, float]]       # qid -> docid -> grade
    doc_index: dict[str, int]                # docid -> dense int

    @property
    def qids(self) -> list[str]:
        return sorted(self.gains)

    def graded(self, qids: list[str]) -> list[dict[int, float]]:
        """Positive-gain judgments in dense-int space, one dict per qid
        (missing qids -> empty: unjudged queries score zero)."""
        return [{self.doc_index[d]: g
                 for d, g in self.gains.get(q, {}).items() if g > 0}
                for q in qids]


def load_qrels(path) -> TrecQrels:
    gains: dict[str, dict[str, float]] = {}
    doc_index: dict[str, int] = {}
    for ln, line in enumerate(Path(path).read_text().splitlines(), 1):
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 4:
            raise ValueError(f"{path}:{ln}: expected 'qid iter docid "
                             f"grade', got {line!r}")
        qid, _, docid, grade = parts
        gains.setdefault(qid, {})[docid] = float(grade)
        doc_index.setdefault(docid, len(doc_index))
    return TrecQrels(gains=gains, doc_index=doc_index)


def load_run(path, qrels: TrecQrels,
             depth: int = 1000) -> tuple[list[str], np.ndarray]:
    """Read a TREC run into a ranked [Q, depth] dense-int id matrix.

    Rows follow the run's qid order of first appearance; within a row,
    results are ordered by the file's rank column. Docids never seen in
    the qrels map to fresh indices (they are unjudged, not errors);
    rows shorter than ``depth`` pad with the -1 sentinel."""
    per_q: dict[str, list[tuple[int, str]]] = {}
    order: list[str] = []
    for ln, line in enumerate(Path(path).read_text().splitlines(), 1):
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 6:
            raise ValueError(f"{path}:{ln}: expected 'qid Q0 docid rank "
                             f"score tag', got {line!r}")
        qid, _, docid, rank, _, _ = parts
        if qid not in per_q:
            per_q[qid] = []
            order.append(qid)
        per_q[qid].append((int(rank), docid))
    ids = np.full((len(order), depth), -1, np.int32)
    for row, qid in enumerate(order):
        ranked = sorted(per_q[qid])[:depth]
        for col, (_, docid) in enumerate(ranked):
            ids[row, col] = qrels.doc_index.setdefault(
                docid, len(qrels.doc_index))
    return order, ids


def write_run(path, qids: list[str], ids: np.ndarray, scores: np.ndarray,
              tag: str = "repro") -> None:
    """Emit a ranked batch as a TREC run file (integer docids are
    written verbatim as the docid tokens; -1 sentinels are dropped)."""
    lines = []
    for qid, row_ids, row_scores in zip(qids, np.asarray(ids),
                                        np.asarray(scores)):
        rank = 0
        for d, s in zip(row_ids, row_scores):
            if int(d) < 0:
                continue
            rank += 1
            lines.append(f"{qid} Q0 {int(d)} {rank} {float(s):.6f} {tag}")
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def evaluate_trec(run_path, qrels_path) -> dict[str, float]:
    """Score a TREC run file against a TREC qrels file with the same
    metric grid the synthetic harness reports."""
    qrels = load_qrels(qrels_path)
    qids, ids = load_run(run_path, qrels)
    return evaluate_ranking(ids, qrels.graded(qids))
