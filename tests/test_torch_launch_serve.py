"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), on the CPU.

Its flags are the reference's, less ``--host-devices`` (XLA's fake host
devices) and plus ``--device``. Runs at 2048 documents and 32 requests go
through ``main(argv)`` in-process; two of them are also run as
``python -m repro.launch.serve`` subprocesses with the same flags, and the
stats that do not depend on the clock (the request count, requests per
route, the index generation, cache evictions at the swap, rejections) must
be equal. Batch counts and latencies depend on arrival timing and are not
compared.

The mesh path runs in 2 and 4 gloo ranks (``torch_ranks.run_ranks``, jax
and repro blocked), each calling ``main(... --shards N --device cpu)``:
every rank's clock-free stats and served ids and scores must equal the
single-process emulation's.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.serve import AsyncRetrievalScheduler
from torch_ranks import BLOCK_JAX, run_ranks

SRC = Path(__file__).resolve().parents[1] / "src"
SMALL = ["--docs", "2048", "--requests", "32"]
CLOCK_FREE = ("n", "submitted", "completed", "requests_by_route",
              "generation", "swaps", "cache_gen_evictions", "rejected")


def _reference(args, timeout=600):
    """The reference launcher in a subprocess: (its stats dict, stdout)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _stats(stdout) -> dict:
    line = [ln for ln in stdout.splitlines() if ln.startswith("{'n':")][-1]
    return ast.literal_eval(line)


def _flags(help_text) -> set:
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z-]*)", help_text))


def test_flags_are_the_references_less_host_devices_plus_device(capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--help"])
    assert exit_.value.code == 0
    port = _flags(capsys.readouterr().out)
    ref = _flags(_reference(["--help"]))
    assert "--host-devices" in ref and "--device" not in ref
    assert port == (ref - {"--host-devices"}) | {"--device"}


def _run(capsys, *args) -> tuple:
    stats = serve.main([*SMALL, "--device", "cpu", *args])
    return stats, capsys.readouterr().out


@pytest.mark.parametrize("args", [
    (), ("--routing", "table8", "--cache", "16"), ("--shards", "2"),
    ("--swap-demo", "--cache", "16"), ("--executors", "2")],
    ids=["default", "table8-cache", "shards2", "swap", "executors2"])
def test_launcher_runs_on_cpu(capsys, args):
    stats, out = _run(capsys, *args)
    n = 16 if "--swap-demo" in args else 32
    assert stats["n"] == n and stats["completed"] == 32
    assert stats["failed"] == 0 and stats["rejected"] == 0
    assert sum(stats["requests_by_route"].values()) == stats["submitted"]
    assert _stats(out) == stats                    # the printed line
    if "--shards" in args:
        assert "# sharded serving: 2 shards (emulated)" in out
        assert set(stats["requests_by_route"]) == {"all"}
    if "--routing" in args:
        assert set(stats["requests_by_route"]) <= {"short", "long"}
    if "--swap-demo" in args:
        assert stats["generation"] == 1
        assert "# hot-swap: installed generation 1" in out
    if "--executors" in args:
        assert sum(stats["batches_by_executor"].values()) == stats["batches"]


@pytest.mark.parametrize("args", [
    ("--routing", "table8", "--cache", "16", "--k-mix", "10", "100"),
    ("--swap-demo", "--cache", "16")], ids=["table8-cache", "swap"])
def test_clock_free_stats_equal_the_reference(capsys, args):
    stats, out = _run(capsys, *args)
    ref_out = _reference([*SMALL, *args])
    ref = _stats(ref_out)
    assert {k: stats[k] for k in CLOCK_FREE} == {k: ref[k] for k in
                                                 CLOCK_FREE}
    comments = [ln for ln in out.splitlines() if ln.startswith("# ")]
    assert comments == [ln for ln in ref_out.splitlines()
                        if ln.startswith("# ")]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_without_a_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.main([*SMALL, "--device", "cuda"])
    assert exit_.value.code != 0
    assert "CUDA is not available" in capsys.readouterr().err


def _record_handles(monkeypatch) -> list:
    """Every handle the scheduler's ``submit`` returns, in request order."""
    handles, submit = [], AsyncRetrievalScheduler.submit

    def recording(self, *a, **kw):
        handles.append(submit(self, *a, **kw))
        return handles[-1]
    monkeypatch.setattr(AsyncRetrievalScheduler, "submit", recording)
    return handles


def _served(handles) -> dict:
    return {"ids": [h.result().ids.tolist() for h in handles],
            "scores": [h.result().scores.tolist() for h in handles]}


_MESH_SCRIPT = BLOCK_JAX + textwrap.dedent("""
    import contextlib
    import io
    import json
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.serve import AsyncRetrievalScheduler

    rank, store = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=N_RANKS)
    handles, submit = [], AsyncRetrievalScheduler.submit

    def recording(self, *a, **kw):
        handles.append(submit(self, *a, **kw))
        return handles[-1]
    AsyncRetrievalScheduler.submit = recording
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve.main(ARGV)
    mesh_line = f"# sharded serving: {N_RANKS} shards (mesh)" in out.getvalue()
    dist.destroy_process_group()
    print("RESULT:" + json.dumps({
        "mesh": mesh_line,
        "stats": {k: stats[k] for k in CLOCK_FREE},
        "ids": [h.result().ids.tolist() for h in handles],
        "scores": [h.result().scores.tolist() for h in handles]}))
""")


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_ranks_serve_as_the_emulation(capsys, monkeypatch, tmp_path, n):
    """``--shards N`` in N gloo ranks takes the mesh path; every rank's
    clock-free stats and served ids and scores equal the emulation's."""
    args = ["--docs", "4096", "--requests", "24", "--shards", str(n),
            "--exchange-every", "1", "--k-mix", "10", "100", "--device",
            "cpu"]
    handles = _record_handles(monkeypatch)
    stats = serve.main(args)
    assert f"# sharded serving: {n} shards (emulated)" in \
        capsys.readouterr().out
    want = {"mesh": True, "stats": {k: stats[k] for k in CLOCK_FREE},
            **_served(handles)}
    script = (_MESH_SCRIPT.replace("N_RANKS", str(n))
              .replace("ARGV", repr(args))
              .replace("CLOCK_FREE", repr(CLOCK_FREE)))
    outs = run_ranks(script, n, tmp_path)
    assert len(want["ids"]) == 24
    for rank, out in enumerate(outs):
        assert out == json.loads(json.dumps(want)), f"rank {rank}"


def test_mesh_refuses_clock_dependent_batching(tmp_path):
    """On a mesh, ``--executors`` and ``--deadline-ms`` would let the ranks
    form different batches: the launcher refuses them."""
    script = BLOCK_JAX + textwrap.dedent("""
        import json
        import torch.distributed as dist
        from repro_torch.launch import serve
        rank, store = int(sys.argv[1]), sys.argv[2]
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=2)
        codes = []
        for extra in (["--executors", "2"], ["--deadline-ms", "50"]):
            try:
                serve.main(["--docs", "2048", "--requests", "4", "--shards",
                            "2", "--device", "cpu", *extra])
                codes.append(0)
            except SystemExit as e:
                codes.append(e.code)
        dist.destroy_process_group()
        print("RESULT:" + json.dumps(codes))
    """)
    assert run_ranks(script, 2, tmp_path) == [[2, 2], [2, 2]]
