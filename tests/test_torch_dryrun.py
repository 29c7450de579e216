"""The port's dry run (``repro_torch.launch.dryrun``): cells traced on a fake
world, and the same steps run on real gloo ranks.

The reference's ``tests/test_dryrun_subprocess.py::
test_dryrun_small_mesh_compiles`` lowers three cells on 8 fake XLA
devices; on jax 0.9 it stops in ``Rules.c`` (a ``with_sharding_constraint``
on an ``AbstractMesh`` of Explicit axes), so no test here leans on it. Its
counterpart traces the same three cells on a fake world of 8 ranks. The
fake world's counts are then held to a real run: the same steps, at smoke
width, on 8 gloo ranks (subprocesses with jax and the reference blocked)
must record the same collectives (kinds, counts and bytes), the same
per-device FLOPs and the same argument bytes.
"""
import json
import textwrap

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_mesh

from torch_ranks import BLOCK_JAX, run_ranks

REFERENCE_CELLS = [("internlm2-1.8b", "train_4k"), ("schnet", "molecule"),
                   ("two-tower-retrieval", "retrieval_cand")]


def test_small_mesh_traces():
    """The reference test's three cells, full size, on a fake 4 x 2 world:
    each traces, counts FLOPs, and the sharded LM train step
    communicates."""
    for arch_id, shape in REFERENCE_CELLS:
        rec = D.run_cell(arch_id, shape, "4x2", mesh_shape=(4, 2),
                         device="cpu", write=False, fit=False)
        assert rec["ok"], rec.get("traceback")
        assert rec["flops"] > 0 and rec["devices"] == 8
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert set(rec["collectives"]) == set(D.COLLECTIVES)
        if arch_id == "internlm2-1.8b":
            assert sum(v["count"] for v in rec["collectives"].values()) > 0
            assert rec["collectives"]["all-reduce"]["bytes"] > 0
        assert not dist.is_initialized()


def test_fake_world_is_gone_and_refused_over_a_group(tmp_path):
    rec = D.run_cell("din", "serve_p99", "4x2", mesh_shape=(4, 2),
                     device="cpu", write=False, fit=False)
    assert rec["ok"] and not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="exists"):
            D.run_cell("din", "serve_p99", "4x2", mesh_shape=(4, 2),
                       device="cpu", write=False)
        assert dist.get_world_size() == 1      # the caller's group stands
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id,shape,held", [
    ("internlm2-1.8b", "decode_32k", ("flops", "bytes", "collectives")),
    # SchNet's bytes are mostly its inputs' and the RBF expansion's: the
    # per-layer delta is under a quarter of f(2), where the reference's
    # fit takes f(2) / 2 per layer instead
    ("schnet", "molecule", ("flops", "collectives"))])
def test_extrapolated_equals_direct_count(arch_id, shape, held):
    """Every layer is traced, so the reference's fit from depths 1 and 2
    equals the direct count where the fit is not degenerate."""
    rec = D.run_cell(arch_id, shape, "4x2", mesh_shape=(4, 2), device="cpu",
                     write=False)
    ex = rec["extrapolated"]
    assert rec["ok"] and ex["depth"] > 2
    if "flops" in held:
        assert ex["flops"] == rec["flops"] > 0
    if "bytes" in held:
        assert ex["bytes_accessed"] == rec["bytes_accessed"]
    if "collectives" in held:
        for kind in D.COLLECTIVES:
            assert ex["collectives"][kind]["bytes"] == \
                rec["collectives"][kind]["bytes"], kind


def test_main_writes_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "ART_DIR", tmp_path)
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "din", "--shape", "serve_p99", "--mesh", "single",
                "--device", "cpu"])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "pod16x16__din__serve_p99.json").read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["variant"] == "tp"
    assert rec["device_type"] == "cpu" and rec["trace_s"] > 0
    for key in ("arch", "shape", "mesh", "memory", "flops", "bytes_accessed",
                "collectives", "extrapolated"):
        assert key in rec
    assert "1 ok, 0 failed" in capsys.readouterr().out


# The smoke-width cells of the fake-against-real comparison, as source:
# the rank script runs it too.
CASES = textwrap.dedent('''
    import torch
    from repro_torch.configs import get_arch

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def cases():
        """(name, arch, shape, cfg, spec, effective variant, variant, the
        bound of each integer input)."""
        out = []
        arch = get_arch("internlm2-1.8b")
        cfg = arch.smoke()
        out.append(("lm_train", arch, "train_4k", cfg, {
            "kind": "train", "inputs": {"batch": {
                "tokens": meta((8, 16)), "targets": meta((8, 16))}}},
            "fsdp", "opt", {"tokens": cfg.vocab, "targets": cfg.vocab}))
        arch = get_arch("dlrm-rm2")
        cfg = arch.smoke()
        out.append(("dlrm_serve", arch, "serve_p99", cfg, {
            "kind": "serve", "inputs": {"batch": {
                "dense": meta((8, cfg.n_dense), torch.float32),
                "sparse": meta((8, cfg.n_sparse, cfg.multi_hot))}}},
            "tp", "opt", {"sparse": cfg.vocab_per_field}))
        arch = get_arch("two-tower-retrieval")
        cfg = arch.smoke()
        out.append(("two_tower_retrieval", arch, "retrieval_cand", cfg, {
            "kind": "retrieval", "inputs": {
                "user_feats": meta((1, cfg.user_bag)),
                "cand_emb": meta((1024, cfg.tower_mlp[-1]), torch.float32)}},
            "tp", "opt", {"user_feats": cfg.n_user_feats}))
        return out
''')

_REAL = BLOCK_JAX + CASES + textwrap.dedent('''
    import json, sys
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist.sharding import placements
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store, 8),
                            rank=rank, world_size=8)
    mesh = make_mesh(4, 2, device_type="cpu")
    gen = torch.Generator().manual_seed(0)

    def inputs(tree, bounds, name=""):
        if isinstance(tree, dict):
            return {k: inputs(v, bounds, k) for k, v in tree.items()}
        if tree.dtype == torch.float32:
            return torch.randn(tree.shape, generator=gen)
        return torch.randint(0, bounds[name], tree.shape, generator=gen,
                             dtype=tree.dtype)

    res = {}
    for name, arch, shape, cfg, spec, eff, variant, bounds in cases():
        trees, specs = D.cell_specs(arch, shape, cfg, spec, mesh, eff)
        params = TS.init_fn(arch, shape, cfg, device="cpu")(0)
        if spec["kind"] in D.TRAIN_KINDS:
            real = ({"params": params, "opt": adamw_init(params)},
                    inputs(spec["inputs"]["batch"], bounds))
        else:
            real = (params,) + tuple(inputs(v, bounds, k)
                                     for k, v in spec["inputs"].items())
        placed = unflatten(trees, [
            distribute_tensor(t, mesh, placements(s, mesh),
                              src_data_rank=None)
            for t, s in zip(leaves(real), leaves_up_to(trees, specs))])
        step = D.cell_step(arch, shape, cfg, spec, mesh, eff, variant)
        out = D.trace(step, placed)
        res[name] = {"flops": out["flops"], "collectives": out["collectives"],
                     "argument_bytes":
                         out["memory"]["argument_size_in_bytes"]}
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(res))
''')


def test_fake_trace_equals_gloo_ranks(tmp_path):
    """Smoke-width internlm2 train (opt: FSDP), dlrm serve_p99 and the
    two-tower retrieval step (opt: the sharded top-k), traced on a fake
    4 x 2 world, count what rank 0 of 8 gloo ranks counts running them:
    the same collectives by kind (count and bytes), FLOPs and argument
    bytes."""
    ns = {}
    exec(CASES, ns)
    fake = {}
    with fake_world(8):
        mesh = make_mesh(4, 2, device_type="cpu")
        for name, arch, shape, cfg, spec, eff, variant, _ in ns["cases"]():
            out = D.trace(*D.lower_spec(arch, shape, cfg, spec, mesh, eff,
                                        variant, "cpu"))
            fake[name] = out
    real = run_ranks(_REAL, 8, tmp_path, timeout=300)[0]
    for name, out in fake.items():
        assert real[name]["flops"] == out["flops"] > 0, name
        assert real[name]["argument_bytes"] == \
            out["memory"]["argument_size_in_bytes"], name
        assert real[name]["collectives"] == out["collectives"], name
        assert sum(v["count"] for v in out["collectives"].values()) > 0, name
