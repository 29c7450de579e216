"""Qrels-based relevance harness: did the fast thing return the right
documents?

This package answers "how good", next to "how fast", from the same run,
because the paper's claim (guided traversal keeps quality until small-k
misalignment breaks it; hybrid second stages recover it) is a joint
quality-vs-latency statement:

  - :mod:`synthetic`: graded-qrels corpora with a planted dense
    modality consistent with the sparse relevance structure
    (``make_graded_corpus`` / ``build_hybrid``);
  - :mod:`harness`: the evaluation entry points: ``evaluate_ranking``
    (MRR@10 / nDCG@10 / Recall@{10,100} from any ranked-id batch) and
    ``evaluate_retriever`` (one engine -> quality metrics + warmed MRT);
  - :mod:`trec`: TREC qrels/run file interchange, so the same harness
    scores real collections (``evaluate_trec``).
"""
from .harness import (QUALITY_METRICS, evaluate_ranking,  # noqa: F401
                      evaluate_retriever)
from .synthetic import (GradedCorpus, build_hybrid,  # noqa: F401
                        make_graded_corpus)
from .trec import (TrecQrels, evaluate_trec, load_qrels,  # noqa: F401
                   load_run, write_run)
