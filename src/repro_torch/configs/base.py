"""ArchSpec: a selectable architecture (``--arch <id>``) and its shape cells."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys"
    source: str                       # public-literature citation
    make_config: Callable[[], Any]    # full published config
    make_smoke: Callable[[], Any]     # reduced same-family config
    shapes: tuple[str, ...]           # assigned shape-cell names
    notes: str = ""

    def config(self) -> Any:
        return self.make_config()

    def smoke(self) -> Any:
        return self.make_smoke()


# Assigned shape-cell names per family.
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
