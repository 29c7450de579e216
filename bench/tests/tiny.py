"""A copy of the benchmark's data files at a size the CPU runs in seconds:
2^14 docs over 2,048 terms, tiles of 256, a pool of 64 queries, batches of
16. The runners, the reference and the metric readers are the package's
own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


# a cell the tests also run: splade's queries at k=10 (not a benchmark
# cell: its trip count, and so its rate, follows the batch's slowest row)
EXTRA = {"name": "splade.b512.k10", "config": "splade-msmarco-1m",
         "traffic": "b512.k10", "chips": 1, "why": "tests only"}


def tiny_root(dst: Path, n_docs: int = 1 << 14) -> Path:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(EXTRA)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    for group in ("configs", "traffic", "checks"):
        (dst / "bench" / group).mkdir(parents=True)
        for f in (ROOT / "bench" / group).glob("*.json"):
            d = json.loads(f.read_text())
            if group == "configs":
                d["n_docs"], d["n_terms"] = n_docs, 2048
                d["queries"]["n"] = 64
                d["index"]["tile_size"] = 256
            if group == "traffic":
                d["batch"] = 16
            (dst / "bench" / group / f.name).write_text(json.dumps(d))
    shutil.copy(dst / "bench" / "checks" / "splade.b512.k1000.json",
                dst / "bench" / "checks" / f"{EXTRA['name']}.json")
    return dst


def tiny_config(name: str, **over) -> dict:
    d = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    d.update(over)
    return d
