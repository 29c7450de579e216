"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m bench.run --workload splade.b512.k1000 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. The cell names a configuration
(``bench/configs/<config>.json``, whose ``runner`` names the module under
``bench/runners/`` that builds and drives the system), a traffic mix
(``bench/traffic/<traffic>.json``) and has its correctness limits in
``bench/checks/<cell>.json``. Set-up (``setup_s``: process start to the
first timed search) builds the system from the seed and warms up every
shape of the traffic; the window then runs searches for ``--seconds``.
With ``--trace 1`` a profiler traces the window (at most
``TRACE_SECONDS``) and the cell's per-layer metrics are reported instead
of its end-to-end ones. After the window the program's state is freed and
the reference checks a sample of what the window returned.

The last line of standard output is the result; the last lines of
standard error each give a compared number beside its limit. The exit
code is not 0, and no result is printed, without a CUDA device for the
cell, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = process_start()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"bench.run: no workload {workload!r} in "
                     f"BENCHMARK.json")


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its per-layer ones when
    traced, else its end-to-end ones."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Run:
    """What the metric readers (``bench/metrics/<name>.py``) read."""
    cfg: dict
    searches: list          # one record per search of the window
    window_s: float
    setup_s: float
    index_bytes: int
    n_docs: int
    device_name: str
    trace: dict | None      # ``bench.trace.reduce`` of the traced window
    k1: dict | None         # K1's work in the traced window (``k1_work``)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float | None = None) -> dict:
    """Set up, warm up, measure, check and read the metrics of one run.
    Returns the result (``checks`` last)."""
    import torch
    t_start = T_START if t_start is None else t_start
    spec = load_json(root / "BENCHMARK.json")
    cell = spec_cell(spec, workload)
    bench = root / "bench"
    cfg = load_json(bench / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench / "checks" / f"{workload}.json")
    runner = importlib.import_module(f"bench.runners.{cfg['runner']}")
    on_card = device == "cuda"

    system = runner.Cell(cfg, traffic, seed, device)
    system.build()
    system.warmup()
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer()
        tracer.warm(lambda: torch.zeros(1, device=device).add_(1))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    records, failed, attempted = [], 0, 0
    with tracer if tracer is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        i = 0
        while True:
            x = system.inputs(i)
            attempted += len(x["terms"])
            try:
                rec = system.step(i, x)
                rec["i"] = i
                records.append(rec)
            except RuntimeError as err:
                print(f"bench.run: search {i} failed: {err}",
                      file=sys.stderr)
                failed += len(x["terms"])
            i += 1
            if time.perf_counter() - t0 >= window:
                break
        window_s = time.perf_counter() - t0
    trace_summary = tracer.summary() if tracer is not None else None
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"

    system.close()
    check = system.check(int(limits["sample_rows"]),
                         [r["i"] for r in records], work=trace)
    numbers = check["numbers"]
    correct = bool(records) and all(
        numbers[n] <= lim for n, lim in limits["limits"].items())

    run = Run(cfg=cfg, searches=records, window_s=window_s,
              setup_s=setup_s, index_bytes=system.index_bytes,
              n_docs=system.n_docs, device_name=device_name,
              trace=trace_summary, k1=check.get("k1_work"))
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        reader = importlib.import_module(f"bench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace_summary is not None:
        from .trace import top_entries
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {
            "device_ops": top_entries(trace_summary["device_ops"]),
            "idle_gaps": top_entries(trace_summary["idle_gaps"])}
    result["info"] = {"searches": len(records), "window_s": window_s,
                      "per_search": [[round(r["latency_s"], 4), r["steps"]]
                                     for r in records],
                      "setup_s": setup_s, **system.timings,
                      "check": {k: v for k, v in check.items()
                                if k != "numbers"},
                      **({"trace_events": trace_summary["n_events"],
                          "trace_reduce_s": trace_summary["reduce_s"]}
                         if trace_summary else {})}
    result["checks"] = {n: {"value": numbers[n], "limit": lim}
                        for n, lim in limits["limits"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    chips = spec_cell(load_json(ROOT / "BENCHMARK.json"),
                      args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench.run: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"bench.run: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
