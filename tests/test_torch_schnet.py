"""The port's SchNet (``repro_torch.models.schnet``) and its GNN cells
against the JAX package, on the same numpy-seeded inputs and the
reference's parameters carried over by ``bridge.schnet_params_from_arrays``.

Tolerances: energies, logits and losses within rtol 1e-5 (atol 1e-6 for
values near zero); every gradient leaf within 1e-4 max|ref| + 1e-6 of
``jax.value_and_grad``'s (the port adds messages into their nodes with
``index_add``, the reference with ``segment_sum``, and the products sum
in other orders). The RBF centres are bit-equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro.models import schnet as JSN
from repro.models.transformer import NO_RULES
from repro_torch import bridge, tree
from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import steps as TS
from repro_torch.models import schnet as S
from repro_torch.train.optimizer import AdamWConfig, adamw_init

SMOKE = dict(n_interactions=2, d_hidden=16, n_rbf=24, cutoff=5.0,
             n_atom_types=8)


def _cfgs(**kw):
    return JSN.SchNetConfig(**kw), S.SchNetConfig(**kw)


def _carried(jcfg, cfg, seed=0):
    jparams = JSN.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.schnet_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _both(batch: dict):
    """A numpy batch as the reference's and the port's inputs."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _molecules(rng, b=3, n=6, e=12, n_types=8, pad_edges=0, pad_atoms=0):
    es = rng.integers(0, n, (b, e)).astype(np.int32)
    ed = rng.integers(0, n, (b, e)).astype(np.int32)
    if pad_edges:
        es[:, -pad_edges:] = -1
        ed[:, -pad_edges:] = -1
    z = rng.integers(1, n_types, (b, n)).astype(np.int32)
    if pad_atoms:
        z[:, -pad_atoms:] = 0
    return {"z": z,
            "pos": rng.standard_normal((b, n, 3)).astype(np.float32),
            "edge_src": es, "edge_dst": ed,
            "energy": rng.standard_normal(b).astype(np.float32)}


def _graph(rng, nn, ee, d_feat, n_out, cutoff, mask=None):
    return {"x": rng.standard_normal((nn, d_feat)).astype(np.float32),
            "edge_src": rng.integers(0, nn, ee).astype(np.int32),
            "edge_dst": rng.integers(0, nn, ee).astype(np.int32),
            "edge_dist": (rng.random(ee) * cutoff).astype(np.float32),
            "labels": rng.integers(0, n_out, nn).astype(np.int32),
            "train_mask": (np.ones(nn, np.float32) if mask is None
                           else mask)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _grad_close(got, want):
    gl, wl = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6)


# -- the RBF centres and the padded edge --------------------------------------

@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (24, 5.0), (2, 1.0),
                                          (1000, 1.0), (64, 7.5)])
def test_rbf_centres_bit_equal_reference(n_rbf, cutoff):
    """The centres equal ``jnp.linspace`` bit for bit, called alone and
    inside a jitted function (as the reference's ``rbf_expand`` runs)."""
    got = S.rbf_centres(n_rbf, cutoff)
    alone = np.asarray(jnp.linspace(0.0, cutoff, n_rbf, dtype=jnp.float32))
    inside = np.asarray(jax.jit(lambda d: jnp.linspace(
        0.0, cutoff, n_rbf, dtype=d.dtype) + d)(jnp.zeros((), jnp.float32)))
    np.testing.assert_array_equal(got, alone)
    np.testing.assert_array_equal(got, inside)
    assert got[-1] == np.float32(cutoff)


def test_torch_linspace_is_not_the_reference_centres():
    """Why the port does not use ``torch.linspace``: it rounds 124 of the
    full config's 300 centres otherwise."""
    plain = torch.linspace(0.0, 10.0, 300).numpy()
    assert (plain != S.rbf_centres(300, 10.0)).sum() == 124


def test_rbf_expand_matches_reference():
    d = np.random.default_rng(0).random(50).astype(np.float32) * 12
    got = S.rbf_expand(torch.from_numpy(d), 300, 10.0)
    want = JSN.rbf_expand(jnp.asarray(d), 300, 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    # at the cutoff the last centre has weight 1: a padded edge is not silent
    at_cut = S.rbf_expand(torch.tensor([10.0]), 300, 10.0)
    assert float(at_cut[0, -1]) == 1.0


def test_padded_edges_send_messages_as_the_reference():
    """A batch with padded edges (-1) and padded atoms (z 0): per-molecule
    energies equal the reference's; each padded edge sends atom 0 a
    message (dropping the padded edges changes the energy)."""
    jcfg, cfg = _cfgs(**SMOKE)
    jparams, params = _carried(jcfg, cfg)
    rng = np.random.default_rng(1)
    batch = _molecules(rng, pad_edges=4, pad_atoms=2)
    jb, tb = _both(batch)
    got = S.molecule_energy(cfg, params, tb)
    _close(got, JSN.molecule_energy(jcfg, jparams, jb))
    cut = {**batch, "edge_src": batch["edge_src"][:, :-4],
           "edge_dst": batch["edge_dst"][:, :-4]}
    without = S.molecule_energy(cfg, params, _both(cut)[1])
    assert not torch.allclose(got, without, rtol=1e-4, atol=1e-5)


# -- the reference's test_model_invariants.py SchNet cases --------------------

def test_schnet_energy_translation_invariant():
    """SchNet energies depend on distances only: rigid translation of all
    atom positions must not change the prediction."""
    cfg = S.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=24,
                         cutoff=5.0, n_atom_types=8)
    params = S.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {
        "z": torch.as_tensor(rng.integers(1, 8, (2, 6))),
        "pos": torch.as_tensor(rng.standard_normal((2, 6, 3)),
                               dtype=torch.float32),
        "edge_src": torch.as_tensor(rng.integers(0, 6, (2, 12))),
        "edge_dst": torch.as_tensor(rng.integers(0, 6, (2, 12))),
    }
    e1 = S.molecule_energy(cfg, params, batch)
    shifted = dict(batch, pos=batch["pos"] + torch.tensor([10., -3., 7.]))
    e2 = S.molecule_energy(cfg, params, shifted)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)


def test_schnet_rbf_cutoff_kills_long_edges():
    """Edges at the cutoff contribute (numerically) nothing."""
    r = S.rbf_expand(torch.tensor([0.1, 4.9, 25.0]), 24, 5.0)
    assert float(r[0].max()) > 0.5
    assert float(r[2].max()) < 1e-6  # far beyond cutoff


# -- energies, logits, losses and gradients vs jax.value_and_grad ------------

@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_molecule_energy_loss_and_grads_match_reference(full):
    kw = (dict(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0,
               n_atom_types=100) if full else SMOKE)
    jcfg, cfg = _cfgs(**kw)
    jparams, params = _carried(jcfg, cfg, seed=2)
    batch = _molecules(np.random.default_rng(2), b=4, n=10, e=24,
                       n_types=kw["n_atom_types"], pad_edges=3, pad_atoms=1)
    jb, tb = _both(batch)
    _close(S.molecule_energy(cfg, params, tb),
           JSN.molecule_energy(jcfg, jparams, jb))
    jloss, jgrads = jax.value_and_grad(
        lambda p: JSN.molecule_loss(jcfg, p, jb))(jparams)
    loss, grads = tree.value_and_grad(
        lambda p, b: S.molecule_loss(cfg, p, b), params, tb)
    _close(loss, jloss)
    _grad_close(grads, jgrads)


@pytest.mark.parametrize("mask", ["ones", "partial", "zeros", "absent"])
def test_node_logits_loss_and_grads_match_reference(mask):
    """Graph mode (a linear feature embed, class logits): logits, the
    masked loss (averaged over max(mask.sum(), 1)) and its gradients."""
    jcfg, cfg = _cfgs(**SMOKE, d_feat=12, n_out=5)
    jparams, params = _carried(jcfg, cfg, seed=3)
    rng = np.random.default_rng(3)
    m = {"ones": None, "partial": (rng.random(40) < 0.3).astype(np.float32),
         "zeros": np.zeros(40, np.float32), "absent": None}[mask]
    batch = _graph(rng, 40, 160, 12, 5, 5.0, m)
    if mask == "absent":
        del batch["train_mask"]
    jb, tb = _both(batch)
    _close(S.node_logits(cfg, params, tb),
           JSN.node_logits(jcfg, jparams, jb))
    jloss, jgrads = jax.value_and_grad(
        lambda p: JSN.node_loss(jcfg, p, jb))(jparams)
    loss, grads = tree.value_and_grad(lambda p, b: S.node_loss(cfg, p, b),
                                      params, tb)
    _close(loss, jloss)
    if mask == "zeros":
        assert float(loss) == 0.0
    _grad_close(grads, jgrads)


def test_config_counts_and_bridge_checks():
    for kw in (SMOKE, dict(SMOKE, d_feat=7, n_out=3), {}):
        jcfg, cfg = _cfgs(**kw)
        assert cfg.param_count() == jcfg.param_count()
        jparams, params = _carried(jcfg, cfg)
        assert sum(x.numel() for x in tree.leaves(params)) \
            == cfg.param_count()
        ported = S.init_params(cfg, torch.Generator().manual_seed(0))
        assert S.param_shapes(cfg) == jax.tree_util.tree_map(
            lambda x: tuple(x.shape), ported)
    arrays = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError, match="shapes"):
        bridge.schnet_params_from_arrays(
            dataclasses.replace(cfg, n_interactions=2), arrays, "cpu")
    arrays["out2"]["b"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="shapes"):
        bridge.schnet_params_from_arrays(cfg, arrays, "cpu")


# -- the cells: the reference's test_arch_smoke.py GNN cases ------------------

def test_all_cells_enumerate_40():
    cells = list(all_cells())
    assert len(cells) == 40 and len(set(cells)) == 40
    assert cells == list(jax_all_cells())
    assert get_arch("schnet").source == jax_get_arch("schnet").source


@pytest.mark.parametrize("arch_id,shape", [
    ("schnet", "full_graph_sm"), ("schnet", "minibatch_lg"),
    ("schnet", "ogb_products")])
def test_smoke_gnn_graph_cells(arch_id, shape):
    """The reference's test on the port (adapt_config, a train step, the
    loss finite); and the first loss and gradients, from the reference's
    parameters on the same smoke batch, those of its train step."""
    arch = get_arch(arch_id)
    cfg = TS.adapt_config(arch, shape, arch.smoke())
    params = TS.init_fn(arch, shape, cfg, device="cpu")(2)
    state = {"params": params, "opt": adamw_init(params)}
    batch = TS.smoke_batch(arch, shape, cfg, device="cpu")
    step = TS.make_train_step(arch, shape, cfg, opt_cfg=AdamWConfig(
        warmup_steps=1, total_steps=10))
    state, metrics = step(state, batch["batch"])
    assert np.isfinite(float(metrics["loss"]))
    jarch = jax_get_arch(arch_id)
    jcfg = JS.adapt_config(jarch, shape, jarch.smoke())
    assert (cfg.d_feat, cfg.n_out) == (jcfg.d_feat, jcfg.n_out)
    jparams = JS.init_fn(jarch, shape, jcfg)(jax.random.PRNGKey(2))
    params = bridge.schnet_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jbatch = JS.smoke_batch(jarch, shape, jcfg)["batch"]
    for k, v in batch["batch"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]))
    jloss, jgrads = jax.value_and_grad(
        JS.loss_fn(jarch, shape, jcfg, NO_RULES))(jparams, jbatch)
    loss, grads = tree.value_and_grad(TS.loss_fn(arch, shape, cfg), params,
                                      batch["batch"])
    _close(loss, jloss)
    _grad_close(grads, jgrads)


def test_launcher_data_provider_equals_reference():
    """``launch.train.data_provider`` of the GNN cells: the reference's
    batches (molecule_batch of 8 atoms and 16 edges; a 64-seed subgraph of
    a 2048-node GraphStore), bit-equal."""
    from repro.launch import train as JT
    from repro_torch.launch import train as TT
    arch, jarch = get_arch("schnet"), jax_get_arch("schnet")
    for shape in ("molecule", "full_graph_sm"):
        cfg = TS.adapt_config(arch, shape, arch.smoke())
        jcfg = JS.adapt_config(jarch, shape, jarch.smoke())
        got = TT.data_provider(arch, shape, cfg, 8, device="cpu")(3)
        want = JT.data_provider(jarch, shape, jcfg, 8)(3)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_launcher_trains_schnet_as_reference(tmp_path, capsys, monkeypatch,
                                             shape):
    """``python -m repro_torch.launch.train --arch schnet --device cpu``
    (the molecule cell by default) and ``python -m repro.launch.train``,
    both resuming from one step-0 checkpoint (the reference's initial
    state): the same summary line, and the logged steps' losses and
    gradient norms within rtol 1e-4."""
    import json
    import sys
    from repro.launch import train as JT
    from repro.train import checkpoint as JCK
    from repro.train.optimizer import adamw_init as j_adamw_init
    from repro_torch.launch import train as TT
    jarch = jax_get_arch("schnet")
    jcfg = JS.adapt_config(jarch, shape, jarch.smoke())
    jparams = JS.init_fn(jarch, shape, jcfg)(jax.random.PRNGKey(5))
    extra = [] if shape == "molecule" else ["--shape", shape]
    for side in ("j", "t"):
        JCK.save(tmp_path / side / "ckpt", 0,
                 {"params": jparams, "opt": j_adamw_init(jparams)})
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "schnet", "--steps",
                                      "6", "--out", str(tmp_path / "j")]
                        + extra)
    JT.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    res = TT.main(["--arch", "schnet", "--steps", "6", "--device", "cpu",
                   "--out", str(tmp_path / "t")] + extra)
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith(f"schnet/{shape}: loss")
    assert len(res["losses"]) == 6 and np.isfinite(res["losses"]).all()
    logs = [[json.loads(ln) for ln in (tmp_path / side / "metrics.jsonl")
             .read_text().splitlines()] for side in ("j", "t")]
    assert [r["step"] for r in logs[1]] == [r["step"] for r in logs[0]] \
        == [0, 5]
    for a, b in zip(*logs):
        np.testing.assert_allclose([b["loss"], b["grad_norm"]],
                                   [a["loss"], a["grad_norm"]], rtol=1e-4)
