"""The port's train steps (``launch.steps.loss_fn`` / ``make_train_step``)
against the reference's, for the 10 archs at their smoke configs,
with the reference's parameters carried over by the bridge and the same
smoke batch (drawn by numpy in the same order); and the port of
``tests/test_arch_smoke.py::test_smoke_train_step``.

Tolerances: the loss within rtol 1e-5; every gradient leaf within
1e-4 max|ref| + 1e-6 (the products and reductions sum in other orders, and
the backward passes of the gathers add in other orders); one train step
equal (rtol 1e-6, atol 1e-9: XLA contracts multiply-adds) to the
reference's ``adamw_update`` of those gradients, its gradient norm within
1e-4 and its learning rate within 1e-6 of the reference's. Remat on and off give bit-equal
gradients; ``attn_chunk`` equals the unchunked attention within float32
rounding.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro.models.transformer import NO_RULES
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import adamw_update as j_adamw_update
from repro_torch import bridge, tree
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, adamw_init

TRAIN_SHAPE = {"lm": "train_4k", "gnn": "molecule", "recsys": "train_batch"}


def _carried(arch_id, seed=0):
    """(reference arch, cfg, params, batch; the port's, with the same
    parameters and batch)."""
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    shape = TRAIN_SHAPE[arch.family]
    jcfg, cfg = jarch.smoke(), arch.smoke()
    jparams = JS.init_fn(jarch, shape, jcfg)(jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, jparams)
    if arch.family == "lm":
        params = bridge.transformer_params_from_arrays(cfg, arrays, "cpu")
    elif arch.family == "gnn":
        params = bridge.schnet_params_from_arrays(cfg, arrays, "cpu")
    else:
        params = bridge.recsys_params_from_arrays(cfg, arrays, "cpu")
    jbatch = JS.smoke_batch(jarch, shape, jcfg)["batch"]
    batch = TS.smoke_batch(arch, shape, cfg, device="cpu")["batch"]
    return (jarch, jcfg, jparams, jbatch), (arch, cfg, params, batch), shape


def _grad_close(got, want):
    gl, wl = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6)


def _finite(t):
    return all(bool(torch.isfinite(x.float()).all()) for x in tree.leaves(t))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_grads_match_reference(arch_id):
    (jarch, jcfg, jparams, jbatch), (arch, cfg, params, batch), shape = \
        _carried(arch_id)
    jlfn = JS.loss_fn(jarch, shape, jcfg, NO_RULES)
    jloss, jgrads = jax.jit(jax.value_and_grad(jlfn))(jparams, jbatch)
    loss, grads = tree.value_and_grad(TS.loss_fn(arch, shape, cfg), params,
                                      batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grad_close(grads, jgrads)

    # one train step equals the reference's adamw_update of those
    # gradients (the port's, carried over); its metrics those of the
    # reference's update of its own gradients (its train step's)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    jupdate = jax.jit(functools.partial(
        j_adamw_update, JAdamW(warmup_steps=1, total_steps=10)))
    jgrads_port = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [g.numpy() for g in tree.leaves(grads)])
    want, _, _ = jupdate(jgrads_port, j_adamw_init(jparams), jparams)
    _, _, jmetrics = jupdate(jgrads, j_adamw_init(jparams), jparams)
    state = {"params": params, "opt": adamw_init(params)}
    state, metrics = TS.make_train_step(arch, shape, cfg, T.NO_RULES,
                                        opt_cfg)(state, batch)
    assert torch.equal(metrics["loss"], loss)
    for a, w in zip(tree.leaves(state["params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_train_step(arch_id, monkeypatch):
    """The reference's ``test_smoke_train_step`` on the port; the train
    path runs no kernel (here the plain versions would run; they are
    replaced by functions that raise)."""
    def refuse(*a, **kw):
        raise AssertionError("a train step reached a kernel wrapper")
    monkeypatch.setattr(fa, "flash_attention", refuse)
    monkeypatch.setattr(eb, "embedding_bag", refuse)
    arch = get_arch(arch_id)
    shape = TRAIN_SHAPE[arch.family]
    cfg = TS.adapt_config(arch, shape, arch.smoke())
    params = TS.init_fn(arch, shape, cfg, device="cpu")(0)
    state = {"params": params, "opt": adamw_init(params)}
    batch = TS.smoke_batch(arch, shape, cfg, device="cpu")
    step = TS.make_train_step(arch, shape, cfg, T.NO_RULES,
                              AdamWConfig(warmup_steps=1, total_steps=10))
    state, metrics = step(state, batch["batch"])
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert _finite(state["params"])
    state2, metrics2 = step(state, batch["batch"])
    assert float(metrics2["loss"]) != float(metrics["loss"])


def _lm_grads(cfg, params, batch):
    return tree.value_and_grad(lambda p, b: T.lm_loss(cfg, p, b), params,
                               batch)


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_remat_gradients_bit_equal(arch_id, monkeypatch):
    """``remat=True`` recomputes each layer in the backward pass through
    ``torch.utils.checkpoint``: the same gradients, bit for bit."""
    arch = get_arch(arch_id)
    cfg = arch.smoke()
    params = TS.init_fn(arch, "train_4k", cfg, device="cpu")(3)
    batch = TS.smoke_batch(arch, "train_4k", cfg, device="cpu")["batch"]
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    loss0, g0 = _lm_grads(dataclasses.replace(cfg, remat=False), params,
                          batch)
    assert calls == []
    loss1, g1 = _lm_grads(dataclasses.replace(cfg, remat=True), params, batch)
    assert calls == [False] * cfg.n_layers
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)
    # without gradients (serving) nothing is checkpointed
    with torch.no_grad():
        T.forward(dataclasses.replace(cfg, remat=True), params,
                  batch["tokens"])
    assert len(calls) == cfg.n_layers
    with pytest.raises(NotImplementedError, match="dots"):
        _lm_grads(dataclasses.replace(cfg, remat=True, remat_policy="dots"),
                  params, batch)


def test_attn_chunk_matches_unchunked_and_reference(monkeypatch):
    """``attn_chunk`` runs the query rows in blocks at their own offsets:
    the loss and gradients equal the unchunked ones within float32
    rounding, and the reference's chunked loss."""
    (jarch, jcfg, jparams, jbatch), (arch, cfg, params, batch), shape = \
        _carried("granite-3-2b")
    jcfg = dataclasses.replace(jcfg, attn_chunk=8)
    ccfg = dataclasses.replace(cfg, attn_chunk=8)
    calls = []
    real = T.scores_attention

    def spy(q, k, v, causal, q_offset, chunk=0):
        calls.append((q.shape[1], q_offset))
        return real(q, k, v, causal, q_offset, chunk)
    loss0, g0 = _lm_grads(cfg, params, batch)
    monkeypatch.setattr(T, "scores_attention", spy)
    loss1, g1 = _lm_grads(ccfg, params, batch)
    # per layer: the call over 32 rows, then 4 blocks of 8 at their offsets
    assert calls == [(32, 0), (8, 0), (8, 8), (8, 16), (8, 24)] * cfg.n_layers
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for a, b in zip(tree.leaves(g1), tree.leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    jloss = jax.jit(JS.loss_fn(jarch, shape, jcfg, NO_RULES))(jparams, jbatch)
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-5)


def test_train_loss_chooses_scores_attention_and_gather_bag(monkeypatch):
    """The train path's attention and bag are arguments its losses pass:
    ``scores_attention`` and ``gather_embedding_bag``; the serve path's
    default is the kernel."""
    from repro_torch.models import recsys as R
    seen = []
    real_attn, real_bag = T.scores_attention, R.gather_embedding_bag
    monkeypatch.setattr(T, "scores_attention",
                        lambda *a, **kw: seen.append("scores")
                        or real_attn(*a, **kw))
    monkeypatch.setattr(R, "gather_embedding_bag",
                        lambda *a, **kw: seen.append("gather")
                        or real_bag(*a, **kw))
    for arch_id in ("granite-3-2b", "dlrm-rm2"):
        arch = get_arch(arch_id)
        shape = TRAIN_SHAPE[arch.family]
        cfg = arch.smoke()
        params = TS.init_fn(arch, shape, cfg, device="cpu")(0)
        batch = TS.smoke_batch(arch, shape, cfg, device="cpu")["batch"]
        TS.loss_fn(arch, shape, cfg)(params, batch)
    assert seen == ["scores"] * get_arch("granite-3-2b").smoke().n_layers \
        + ["gather"]
