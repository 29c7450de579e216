"""The check's two readings for one configuration, on a list of seeds.

    python3 -m bench.control --config splade-msmarco-1m --seeds 1 2 3 \\
        --control-seeds 1 2 3 --searches b512.k10=40 b512.k1000=4

For each seed: build the configuration once, then for each traffic mix of
its cells run ``--searches`` searches through the program (the timed path,
at the cell's own batch and k) and read the check's numbers on the
sampled rows (the lower reading); for a control seed also read them with
the reference, on weights rounded to bfloat16, in the program's place
(the control, which must fail). One JSON line per seed and mix. Not run by
the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from .run import ROOT, load_json


def readings(config: str, seeds, control_seeds, searches: dict,
             device="cuda", root=ROOT):
    spec = load_json(root / "BENCHMARK.json")
    cfg = load_json(root / "bench" / "configs" / f"{config}.json")
    runner = importlib.import_module(f"bench.runners.{cfg['runner']}")
    cells = [c for c in spec["workloads"] if c["config"] == config]
    for seed in seeds:
        first = None
        for c in cells:
            if c["traffic"] not in searches:
                continue
            traffic = load_json(root / "bench" / "traffic"
                                / f"{c['traffic']}.json")
            limits = load_json(root / "bench" / "checks"
                               / f"{c['name']}.json")
            cell = runner.Cell(cfg, traffic, seed, device)
            if first is None:
                cell.build()
                first = cell
            else:
                cell.adopt(first)
            cell.warmup()
            n = searches[c["traffic"]]
            for i in range(n):
                cell.step(i, cell.inputs(i))
            ref_m = cell.merged()
            out = {"cell": c["name"], "seed": seed, "searches": n,
                   "program": cell.check(limits["sample_rows"],
                                         list(range(n)), ref_m=ref_m)}
            if seed in control_seeds:
                t0 = time.perf_counter()
                ctl = cell.check(limits["sample_rows"], list(range(n)),
                                 ref_m=ref_m,
                                 control=cell.merged(torch.bfloat16))
                out["control_bf16"] = ctl
                out["control_s"] = time.perf_counter() - t0
            yield out
        if first is not None:
            first.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--searches", nargs="+", required=True,
                    help="traffic=count pairs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    searches = {k: int(v) for k, v in (s.split("=") for s in args.searches)}
    for out in readings(args.config, args.seeds, set(args.control_seeds),
                        searches):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
