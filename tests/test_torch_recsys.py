"""The port's serve steps (``launch.steps.make_serve_step``) against the
reference's, for every ported (arch, serve shape) cell at its smoke
config, with the reference's parameters carried over by the bridge and the
same smoke batch (drawn by numpy in the same order).

Tolerance: recsys scores within rtol/atol 1e-5, the bound
tests/test_kernels.py holds the embedding-bag kernel to (the matrix
products sum in other orders); LM logits and caches within 2e-4, the
flash-attention bound; top-k ids identical. On the CPU the port's kernels
run their plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro.models.transformer import NO_RULES
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import steps as TS
from repro_torch.models import recsys as R

SERVE_CELLS = [(a, s) for a in ARCH_IDS for s in get_arch(a).shapes
               if s not in ("train_4k", "train_batch")
               and get_arch(a).family != "gnn"]


def _leaves(out):
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


@pytest.mark.parametrize("arch_id,shape", SERVE_CELLS)
def test_serve_step_matches_reference(arch_id, shape):
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    jcfg, cfg = jarch.smoke(), arch.smoke()
    jparams = JS.init_fn(jarch, shape, jcfg)(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if arch.family == "lm":
        params = bridge.transformer_params_from_arrays(cfg, tree, "cpu")
    else:
        params = bridge.recsys_params_from_arrays(cfg, tree, "cpu")
    jbatch = JS.smoke_batch(jarch, shape, jcfg)
    batch = TS.smoke_batch(arch, shape, cfg, device="cpu")
    for a, b in zip(_leaves(jbatch), _leaves(batch)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jout = jax.jit(JS.make_serve_step(jarch, shape, jcfg, NO_RULES))(
        jparams, *jbatch.values())
    out = TS.make_serve_step(arch, shape, cfg)(params, *batch.values())
    tol = 2e-4 if arch.family == "lm" else 1e-5
    jl, tl = _leaves(jout), _leaves(out)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            assert np.isfinite(b).all()
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(a, b)


def test_triu_indices_order_is_row_major():
    """DLRM's interaction keeps (i, j), i < j, in jnp.triu_indices' order,
    which is torch.triu_indices' (row-major)."""
    for n in (2, 7, 27):
        iu, ju = jnp.triu_indices(n, k=1)
        t = torch.triu_indices(n, n, offset=1)
        np.testing.assert_array_equal(np.asarray(iu), t[0].numpy())
        np.testing.assert_array_equal(np.asarray(ju), t[1].numpy())
    feats = np.random.default_rng(0).standard_normal((3, 27, 8)).astype(
        np.float32)
    inter = np.einsum("bnd,bmd->bnm", feats, feats)
    iu, ju = np.triu_indices(27, k=1)
    np.testing.assert_allclose(inter[:, iu, ju],
                               R.dot_interaction(torch.from_numpy(feats)),
                               rtol=1e-5, atol=1e-5)


def test_topk_ties_and_order_match_lax_top_k():
    """Descending values; among equal scores the lower index first, as
    lax.top_k orders them."""
    scores = np.random.default_rng(1).integers(0, 6, (3, 200)).astype(
        np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 100)
    tv, ti = TS._topk(torch.from_numpy(scores))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    tv, ti = TS._topk(torch.from_numpy(scores[0, :30]))
    assert ti.shape == (30,)


def test_full_configs_match_reference():
    for arch_id in ARCH_IDS:
        jcfg, cfg = jax_get_arch(arch_id).config(), get_arch(arch_id).config()
        assert cfg.param_count() == jcfg.param_count(), arch_id
        assert get_arch(arch_id).shapes == jax_get_arch(arch_id).shapes


def test_recsys_bridge_checks_the_count():
    jarch, arch = jax_get_arch("dlrm-rm2"), get_arch("dlrm-rm2")
    jparams = JS.init_fn(jarch, "serve_p99", jarch.smoke())(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = bridge.recsys_params_from_arrays(arch.smoke(), tree, "cpu")
    assert torch.equal(params["tables"],
                       torch.from_numpy(np.array(jparams["tables"])))
    tree["top"] = tree["top"][:-1]
    with pytest.raises(ValueError, match="parameters"):
        bridge.recsys_params_from_arrays(arch.smoke(), tree, "cpu")


def test_init_fn_is_seeded_and_counts_match():
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        cfg = arch.smoke()
        a = TS.init_fn(arch, arch.shapes[1], cfg, device="cpu")(3)
        b = TS.init_fn(arch, arch.shapes[1], cfg, device="cpu")(3)
        la, lb = _leaves(a), _leaves(b)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        assert sum(x.numel() for x in la) == cfg.param_count()


def test_dlrm_serve_is_one_embedding_bag_call(monkeypatch):
    """The 26 (smoke: 6) fields go through one embedding-bag call over the
    stacked tables."""
    from repro_torch.models import recsys
    calls = []
    real = recsys.embedding_bag

    def spy(table, idx, w, **kw):
        calls.append(tuple(table.shape))
        return real(table, idx, w, **kw)
    monkeypatch.setattr(recsys, "embedding_bag", spy)
    arch = get_arch("dlrm-rm2")
    cfg = arch.smoke()
    params = TS.init_fn(arch, "serve_p99", cfg, device="cpu")(0)
    batch = TS.smoke_batch(arch, "serve_p99", cfg, device="cpu")
    TS.make_serve_step(arch, "serve_p99", cfg)(params, *batch.values())
    assert calls == [(cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim)]


def test_train_shapes_and_unported_families_raise():
    arch = get_arch("dlrm-rm2")
    with pytest.raises(ValueError, match="no serve step"):
        TS.make_serve_step(arch, "train_batch", arch.smoke())
    # a train cell has a train batch (since the train steps were ported)
    batch = TS.smoke_batch(arch, "train_batch", arch.smoke(), device="cpu")
    assert set(batch["batch"]) == {"dense", "sparse", "label"}
    # the GNN cells are train cells: their serve step is refused
    schnet = get_arch("schnet")
    with pytest.raises(ValueError, match="GNN cells are train-step cells"):
        TS.make_serve_step(schnet, "molecule", schnet.smoke())
