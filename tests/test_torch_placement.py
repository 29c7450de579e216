"""The port's placement layer (``repro_torch.dist.sharding``,
``launch.mesh``, ``train.checkpoint.restore(shardings=)`` and
``launch.steps.make_serve_step(mesh=, sharded_topk=True)``) against the
JAX package.

The rules are pure functions of shapes and of the mesh's axis names and
sizes: each package gets its own shapes (its ``state_specs`` and
``input_specs``; the port's are meta tensors, equal to the reference's leaf
for leaf, ``test_torch_specs.py``) and the same mesh shape, and every spec
must equal the reference's ``PartitionSpec`` entry by entry and print as
it does. The reference's rules wrap each spec in a
``NamedSharding``, which needs real devices; on meshes larger than this
process's one CPU device a stand-in that returns the spec takes its place
(``_ref_specs``). Multi-rank cases run on gloo ranks in subprocesses
(``torch_ranks.run_ranks``), with jax and the reference unimportable;
results are compared bit for bit.
"""
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.dist.sharding as JSH
from repro.configs import get_arch as jax_get_arch
from repro.configs.shapes import input_specs
from repro.launch.steps import state_specs
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.shapes import input_specs as port_input_specs
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import P
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as TS
from repro_torch.train import checkpoint

from torch_ranks import BLOCK_JAX, run_ranks

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "8": ((8,), ("data",))}


def _meshes(name):
    """(the reference's mesh stand-in, the port's) of one mesh shape."""
    sizes, axes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, sizes))),
            types.SimpleNamespace(mesh_dim_names=axes, shape=sizes))


def _ref_specs(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


def _pairs(port, ref, path=""):
    """(path, port spec, reference spec) for each leaf, walking both."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        return [x for k in ref for x in _pairs(port[k], ref[k],
                                               f"{path}/{k}")]
    if isinstance(ref, (list, tuple)) and not isinstance(ref, JP):
        assert len(port) == len(ref), path
        return [x for i, (a, b) in enumerate(zip(port, ref))
                for x in _pairs(a, b, f"{path}/{i}")]
    return [(path, port, ref)]


def _assert_same(port, ref):
    pairs = _pairs(port, ref)
    assert pairs
    for path, p, r in pairs:
        assert isinstance(p, P) and isinstance(r, JP), path
        assert tuple(p) == tuple(r) and repr(p) == repr(r), (path, p, r)


# -- the reference's test_dist.py placement cases, on the port --------------

@pytest.fixture(scope="module")
def mesh11():
    return _meshes("1x1")[1]


def test_activation_rules_tp_vs_fsdp(mesh11):
    tp = SH.activation_rules(mesh11, "tp")
    assert tp.batch == ("data",) and tp.heads == "model"
    assert tp.vocab == "model" and not tp.gather_weights
    fsdp = SH.activation_rules(mesh11, "fsdp")
    assert fsdp.batch == ("data",) and fsdp.heads is None
    assert fsdp.gather_weights
    # every field the reference's, on every mesh shape
    for name in MESHES:
        jm, tm = _meshes(name)
        for variant in ("tp", "fsdp"):
            want = JSH.activation_rules(jm, variant)
            got = SH.activation_rules(tm, variant)
            for f in ("batch", "heads", "kv_seq", "vocab", "dp_size",
                      "gather_weights"):
                assert getattr(got, f) == getattr(want, f), (name, f)


def _lm_specs(mesh, variant):
    arch = get_arch("internlm2-1.8b")
    st = TS.state_specs(arch, "train_4k", arch.config())
    return SH.param_shardings("lm", None, mesh, st["params"], variant)


def test_lm_param_placement(mesh11):
    specs = _lm_specs(mesh11, "tp")
    lay = specs["layers"]
    # projections shard the head/ffn dim; return projections the
    # contraction dim; norms replicate
    assert lay["wq"][-1] == "model" and lay["w_up"][-1] == "model"
    assert lay["wo"][-2] == "model" and lay["w_down"][-2] == "model"
    assert all(s is None for s in lay["attn_norm"])
    assert specs["embed"][0] == "model"
    # optimizer moments inherit the param layout; step replicates
    o_sh = SH.opt_shardings(specs)
    assert o_sh["m"]["layers"]["wq"] == lay["wq"]
    assert o_sh["step"] == P() and repr(o_sh["step"]) == repr(JP())
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    arch = jax_get_arch("internlm2-1.8b")
    st = state_specs(arch, "train_4k", arch.config())
    j_sh = JSH.param_shardings("lm", arch.config(), jmesh, st["params"], "tp")
    j_opt = JSH.opt_shardings(j_sh)
    assert tuple(o_sh["step"]) == tuple(j_opt["step"].spec)
    _assert_same(specs, jax.tree_util.tree_map(lambda s: s.spec, j_sh))


def test_fsdp_shards_params_over_all_axes(mesh11):
    spec = _lm_specs(mesh11, "fsdp")["layers"]["wq"]
    assert ("data", "model") in tuple(spec), spec


def test_input_shardings_batch_and_candidates(mesh11):
    arch = get_arch("two-tower-retrieval")
    cfg = arch.config()
    spec = port_input_specs(arch, "retrieval_cand", cfg)
    in_sh = SH.input_shardings("recsys", cfg, mesh11, spec, "tp")
    # 1M-candidate axis spans the whole mesh; the 1-row user replicates
    assert in_sh["cand_emb"][0] == ("data", "model")
    assert all(s is None for s in in_sh["user_feats"])


def test_non_divisible_dims_replicate():
    """Placement rules at a real tp_size=2 (pure functions, no mesh):
    dims that the axis size does not divide must replicate; each spec
    equal to the reference's."""
    cases = [
        (SH._lm_param_spec, JSH._lm_param_spec, "wq", (7, 13),
         P(None, None)),
        (SH._lm_param_spec, JSH._lm_param_spec, "wq", (7, 16),
         P(None, "model")),
        (SH._lm_param_spec, JSH._lm_param_spec, "wo", (4, 16, 13),
         P(None, "model", None)),
        (SH._lm_param_spec, JSH._lm_param_spec, "embed", (92543, 64),
         P(None, None)),
        (SH._recsys_param_spec, JSH._recsys_param_spec, "item_embed",
         (2_000_000, 128), P("model", None)),
        (SH._recsys_param_spec, JSH._recsys_param_spec, "item_embed",
         (2_000_001, 128), P(None, None))]
    for port, ref, name, shape, want in cases:
        got = port(name, shape, "model", 2)
        assert got == want, (name, shape)
        _assert_same(got, ref(name, shape, "model", 2))


# -- every family's state and every cell's inputs, leaf for leaf -------------

def _states(arch_id):
    """(the reference's arch, config and state specs, the port's state
    specs) of the arch's train cell."""
    jarch = jax_get_arch(arch_id)
    shape = {"lm": "train_4k", "gnn": "ogb_products",
             "recsys": "train_batch"}[jarch.family]
    from repro.launch.steps import adapt_config
    cfg = adapt_config(jarch, shape)
    arch = get_arch(arch_id)
    return (jarch, cfg, state_specs(jarch, shape, cfg),
            TS.state_specs(arch, shape, TS.adapt_config(arch, shape)))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_and_opt_specs_equal_reference(arch_id, monkeypatch):
    """``param_shardings`` (tp and fsdp) of the arch's full config, and the
    moments' ``opt_shardings``, equal the reference's on five mesh shapes
    (dims that an axis does not divide included: 16 and 256 divide fewer
    of them than 1 and 8)."""
    _ref_specs(monkeypatch)
    jarch, cfg, st, port_st = _states(arch_id)
    params = port_st["params"]
    for name in MESHES:
        jm, tm = _meshes(name)
        for variant in ("tp", "fsdp"):
            want = JSH.param_shardings(jarch.family, cfg, jm, st["params"],
                                       variant)
            got = SH.param_shardings(jarch.family, cfg, tm, params, variant)
            _assert_same(got, want)
            opt = SH.opt_shardings(got)
            _assert_same(opt["m"], want)
            _assert_same(opt["v"], want)
    if jarch.family == "gnn":     # SchNet replicates under tp
        jm, tm = _meshes("4x2")
        for _, got, _ in _pairs(
                SH.param_shardings("gnn", cfg, tm, params),
                JSH.param_shardings("gnn", cfg, jm, st["params"])):
            assert all(e is None for e in got)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_equal_reference(arch_id, monkeypatch):
    """``input_shardings`` of each of the arch's four cells (the port's
    ``input_specs`` against the reference's) equals the reference's, tp and
    fsdp, on five mesh shapes."""
    _ref_specs(monkeypatch)
    from repro.launch.steps import adapt_config
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    for shape in jarch.shapes:
        cfg = adapt_config(jarch, shape)
        spec = input_specs(jarch, shape, cfg)
        port_spec = port_input_specs(arch, shape,
                                     TS.adapt_config(arch, shape))
        for name in MESHES:
            jm, tm = _meshes(name)
            for variant in ("tp", "fsdp"):
                _assert_same(
                    SH.input_shardings(jarch.family, cfg, tm, port_spec,
                                       variant),
                    JSH.input_shardings(jarch.family, cfg, jm, spec,
                                        variant))


def test_spec_prints_and_places_as_reference():
    assert repr(P(None, ("data",))) == repr(JP(None, ("data",)))
    assert repr(P(("data", "model"), None)) == repr(JP(("data", "model"),
                                                       None))
    assert P(("data",)) == P("data") and P(None, None) != P()
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert SH.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert SH.placements(P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        SH.placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two"):
        SH.placements(P("model", "model"), mesh)


# -- meshes, the elastic re-shard and the sharded top-k on gloo ranks --------

@pytest.fixture()
def world1(tmp_path):
    """A gloo process group of world size 1 in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_axes_and_guards(world1):
    mesh = M.make_mesh(1, 1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert M.dp_axes(mesh) == ("data",) and M.model_axis(mesh) == "model"
    assert mesh.shape == (1, 1) and M.axis_sizes(mesh) == {"data": 1,
                                                           "model": 1}
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh(1, 1, pods=2, device_type="cpu")
    with pytest.raises(ValueError, match="ranks"):
        M.make_production_mesh(device_type="cpu")


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        M.make_mesh(1, 1, device_type="cpu")


def test_checkpoint_elastic_reshard(tmp_path, world1):
    """The reference's test: save unsharded, restore with explicit
    shardings onto a one-rank mesh; the values equal, the layout the one
    asked for."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = M.make_mesh(1, 1, device_type="cpu")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    checkpoint.save(tmp_path / "ck", 1, state)
    out = checkpoint.restore(tmp_path / "ck", 1, state,
                             shardings={"w": P("data")}, mesh=mesh)
    assert isinstance(out["w"], DTensor)
    assert torch.equal(out["w"].full_tensor(), state["w"])
    assert out["w"].placements == (Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh"):
        checkpoint.restore(tmp_path / "ck", 1, state,
                           shardings={"w": P("data")})


_RESHARD = BLOCK_JAX + textwrap.dedent("""
    import json, sys, tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.sharding import P, placements
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    rank, store = int(sys.argv[1]), sys.argv[2]
    n = int(sys.argv[3])
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    mesh = make_mesh(n, 1, device_type="cpu")
    state = {"w": torch.arange(24, dtype=torch.float32).reshape(8, 3),
             "b": torch.arange(5, dtype=torch.float32),
             "step": torch.tensor(7, dtype=torch.int32)}
    ck = sys.argv[4]
    if rank == 0:                   # saved unsharded, by one process
        checkpoint.save(ck, 1, state)
    dist.barrier()
    sh = {"w": P("data", None), "b": P(None), "step": P()}
    out = checkpoint.restore(ck, 1, state, shardings=sh, mesh=mesh)
    res = {"placements": [str(out["w"].placements)],
           "local": out["w"].to_local().tolist(),
           "full_equal": all(torch.equal(out[k].full_tensor(), state[k])
                             for k in state)}
    # saved from that sharded layout, restored onto another one
    checkpoint.save(ck, 2, out)
    again = checkpoint.restore(ck, 2, state, mesh=mesh, shardings={
        "w": (Replicate(), Shard(1)), "b": P("data"), "step": P()})
    res["placements"].append(str(again["w"].placements))
    res["full_equal_2"] = all(torch.equal(again[k].full_tensor(), state[k])
                              for k in state)
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(res))
""")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_checkpoint_elastic_reshard_ranks(tmp_path, n):
    """A checkpoint saved unsharded restores onto an n-rank ("data",
    "model") mesh with the rows sharded over ``data``: rank r holds rows
    [8r/n, 8(r+1)/n); saved again from that layout (every rank calls
    ``save``), it restores onto another layout; every leaf whole-equal."""
    script = _RESHARD.replace("sys.argv[3]", str(n)).replace(
        "sys.argv[4]", repr(str(tmp_path / "ck")))
    outs = run_ranks(script, n, tmp_path)
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(outs):
        assert out["full_equal"] and out["full_equal_2"], out
        np.testing.assert_array_equal(
            np.array(out["local"]), rows[r * 8 // n:(r + 1) * 8 // n])
        assert out["placements"] == ["(Shard(dim=0), Replicate())",
                                     "(Replicate(), Shard(dim=1))"]


def _two_tower_inputs(seed=0, n=1024):
    """Smoke two-tower parameters and a retrieval batch of ``n``
    candidates with duplicated rows (ties across shards)."""
    arch = get_arch("two-tower-retrieval")
    cfg = arch.smoke()
    params = TS.init_fn(arch, "retrieval_cand", cfg, device="cpu")(seed)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, cfg.tower_mlp[-1])).astype(np.float32)
    emb[n // 2:n // 2 + 64] = emb[:64]          # ties across shards
    batch = {"user_feats": torch.as_tensor(rng.integers(
        1, cfg.n_user_feats, (1, cfg.user_bag)), dtype=torch.int32),
        "cand_emb": torch.from_numpy(emb)}
    return arch, cfg, params, batch


def test_sharded_topk_one_rank_equals_unsharded_and_reference(world1):
    """The sharded step on a one-rank mesh, parameters restored as
    DTensors by ``param_shardings(..., "tp")``, is bit-equal to the
    unsharded step, whose ids equal the reference's."""
    import tempfile
    from repro.launch import steps as JS
    from repro_torch import bridge
    jarch = jax_get_arch("two-tower-retrieval")
    jcfg = jarch.smoke()
    jparams = JS.init_fn(jarch, "retrieval_cand", jcfg)(jax.random.PRNGKey(0))
    arch, cfg, _, batch = _two_tower_inputs()
    params = bridge.recsys_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    mesh = M.make_mesh(1, 1, device_type="cpu")
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 0, params)
        placed = checkpoint.restore(d, 0, params, mesh=mesh, shardings=(
            SH.param_shardings("recsys", cfg, mesh, params, "tp")))
    want = TS.make_serve_step(arch, "retrieval_cand", cfg)(params,
                                                             *batch.values())
    got = TS.make_serve_step(arch, "retrieval_cand", cfg, mesh=mesh,
                             sharded_topk=True)(placed, *batch.values())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jv, ji = JS.make_serve_step(jarch, "retrieval_cand", jcfg, None)(
        jparams, jax.numpy.asarray(batch["user_feats"].numpy()),
        jax.numpy.asarray(batch["cand_emb"].numpy()))
    np.testing.assert_array_equal(np.asarray(ji), want[1].numpy())
    np.testing.assert_allclose(np.asarray(jv), want[0].numpy(), rtol=1e-5,
                               atol=1e-6)


_TOPK = BLOCK_JAX + textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import P, param_shardings, placements
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    rank, store = int(sys.argv[1]), sys.argv[2]
    dp, tp = DP, TP
    dist.init_process_group("gloo", store=dist.FileStore(store, dp * tp),
                            rank=rank, world_size=dp * tp)
    mesh = make_mesh(dp, tp, device_type="cpu")
    arch = get_arch("two-tower-retrieval")
    cfg = arch.smoke()
    params = TS.init_fn(arch, "retrieval_cand", cfg, device="cpu")(0)
    rng = np.random.default_rng(0)
    n = 1024
    emb = rng.standard_normal((n, cfg.tower_mlp[-1])).astype(np.float32)
    emb[n // 2:n // 2 + 64] = emb[:64]
    uf = torch.as_tensor(rng.integers(1, cfg.n_user_feats,
                                      (1, cfg.user_bag)), dtype=torch.int32)
    cand = torch.from_numpy(emb)
    want = TS.make_serve_step(arch, "retrieval_cand", cfg)(params, uf, cand)
    step = TS.make_serve_step(arch, "retrieval_cand", cfg, mesh=mesh,
                              sharded_topk=True)
    whole = step(params, uf, cand)
    sharded = step(params, uf, distribute_tensor(
        cand, mesh, placements(P(("data", "model"), None), mesh),
        src_data_rank=None))
    outs = [whole, sharded]
    from torch.distributed.tensor import DTensor
    gathered, real_full = [], DTensor.full_tensor
    DTensor.full_tensor = lambda self, **kw: (
        gathered.append(tuple(self.shape)) or real_full(self, **kw))
    for variant in ("tp", "fsdp"):       # parameters as DTensors
        specs = param_shardings("recsys", cfg, mesh, params, variant)
        placed = unflatten(params, [
            distribute_tensor(p, mesh, placements(s, mesh),
                              src_data_rank=None)
            for p, s in zip(leaves(params), leaves_up_to(params, specs))])
        outs.append(step(placed, uf, cand))
    res = {"coord": mesh.get_coordinate(),
           "user_embed": str(placed["user_embed"].placements),
           "gathered": gathered,
           "equal": [bool(torch.equal(a[0], want[0])
                          and torch.equal(a[1], want[1]))
                     for a in outs],
           "ids": want[1].tolist()}
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(res))
""")


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (2, 2)])
def test_sharded_topk_ranks_equal_unsharded(tmp_path, dp, tp):
    """The two-tower retrieval step on dp x tp gloo ranks: each rank scores
    its n / R candidate rows (sliced from the whole tensor, or its
    DTensor shard), with plain parameters or DTensors laid out by
    ``param_shardings`` (tp; fsdp, which splits the user table's rows over
    every rank), and every rank returns values and global row ids
    bit-equal to the unsharded step's, ties (duplicated rows in other
    shards) to the lower row."""
    script = _TOPK.replace("DP, TP", f"{dp}, {tp}")
    outs = run_ranks(script, dp * tp, tmp_path)
    assert [o["coord"] for o in outs] == [[r // tp, r % tp]
                                          for r in range(dp * tp)]
    for o in outs:
        assert o["equal"] == [True] * 4, o
        # fsdp splits the user table's rows over both mesh dims; the step
        # gathers the tower's weights, never the table
        assert o["user_embed"] == "(Shard(dim=0), Shard(dim=0))", o
        assert o["gathered"] and all(rows < 1000 for rows, *_ in
                                     o["gathered"]), o
    ids = np.array(outs[0]["ids"])
    assert len(ids) == 100 and len(set(ids.tolist())) == 100


def test_gnn_serve_step_refused():
    arch = get_arch("schnet")
    for shape in arch.shapes:
        with pytest.raises(ValueError, match="train-step cells"):
            TS.make_serve_step(arch, shape, TS.adapt_config(arch, shape))
