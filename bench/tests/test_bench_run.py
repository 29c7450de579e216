"""The result line's form, the refusal without a card, the check for
loaded JAX modules, and the trace reduction."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import run
from bench.tests.tiny import tiny_root
from bench.trace import reduce

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys(tmp_path):
    r = run.run_cell("unicoil.b512.k10", 5, 0.3, False, device="cpu",
                     root=tiny_root(tmp_path))
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] >= 16 and r["failed"] == 0
    assert set(r["metrics"]) == {"qps", "latency_p95_ms", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "splade.b512.k10",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


def test_reduce_a_host_only_trace():
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.randn(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(50):
                x.sort()
    out = reduce(prof.profiler.kineto_results.events())
    assert out["busy_s"] == 0 and out["launches"] == 0
    assert out["window_s"] > 0
    assert max(out["idle_gaps"], key=out["idle_gaps"].get) == \
        "host: aten::sort"
    assert sum(out["idle_gaps"].values()) == pytest.approx(out["window_s"])


@pytest.mark.cuda
def test_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_cell("splade.b512.k10", 3, 1.0, True, device="cuda",
                     root=tiny_root(tmp_path))
    assert r["correct"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    names = [n for n, _ in r["breakdown"]["device_ops"]]
    assert not any(n.startswith("bench.") for n in names)
    share = r["metrics"]["device_idle_share"]["value"]
    assert 0 < share < 100
