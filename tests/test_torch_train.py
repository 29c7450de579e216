"""The port's training substrate (``repro_torch.train``, ``dist.compression``,
``dist.straggler``) against the JAX package's, on the CPU.

First the port's counterparts of the reference's own cases:
``tests/test_substrates.py``'s optimizer (4), checkpoint (2), trainer (4),
error-feedback (1) and straggler (2) cases, and ``tests/test_dist.py``'s
7 compression and straggler cases (``test_compression_is_jittable``
becomes the identity it checks, sent + error = gradient, as the port
compiles nothing). The reference's elastic re-shard waits for the port's
placement rules; its collectives and server cases were ported with
``dist.collectives`` and ``serve``.

Then the port against the reference on the same inputs:
- ``adamw_update`` and ``cosine_schedule``: rtol 1e-6, atol 1e-9 (XLA
  contracts multiply-adds on the CPU; the port rounds each product);
- ``compress_with_feedback``, ties included: within 1 ulp of the
  reference's transmitted values and error;
- checkpoints written by either package restore in the other, every leaf
  bit-equal, with the same manifest paths;
- the toy trainer of ``_mk_trainer`` for 30 steps from the reference's
  initial weights: losses within rtol 1e-5, plain, compressed and with 4
  microbatches;
- a crash at step 17 and a resume: bit-equal to an uninterrupted run.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as JC
from repro.train import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch import tree
from repro_torch.dist.compression import (CompressionConfig,
                                          compress_with_feedback,
                                          compression_ratio,
                                          init_error_feedback, topk_sparsify)
from repro_torch.dist.straggler import StragglerConfig, StragglerMonitor
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule,
                                         flop_regularizer)
from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# -- optimizer ---------------------------------------------------------------

def _quad_loss(params, batch):
    return ((params["w"] - batch["t"]) ** 2).sum()


def test_adamw_converges_quadratic():
    params = {"w": torch.zeros(8)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=300,
                      weight_decay=0.0, schedule="constant")
    batch = {"t": torch.arange(8, dtype=torch.float32) / 8.0}
    for _ in range(300):
        _, g = tree.value_and_grad(_quad_loss, params, batch)
        params, state, _ = adamw_update(cfg, g, state, params)
    np.testing.assert_allclose(params["w"].numpy(), batch["t"].numpy(),
                               atol=1e-2)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    step = lambda s: torch.tensor(s, dtype=torch.int32)  # noqa: E731
    assert float(cosine_schedule(cfg, step(5))) == pytest.approx(0.5)
    assert float(cosine_schedule(cfg, step(10))) == pytest.approx(1.0)
    assert float(cosine_schedule(cfg, step(100))) < 1e-6


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, schedule="constant")
    g = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(cfg, g, state, params)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def test_flop_regularizer_positive_and_sparser_is_smaller():
    dense = torch.ones((4, 16))
    sparse = dense.clone()
    sparse[:, 8:] = 0.0
    assert float(flop_regularizer(sparse)) < float(flop_regularizer(dense))


# -- checkpoint --------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "nested": {"b": torch.tensor(7, dtype=torch.int32)}}
    checkpoint.save(tmp_path, 5, state)
    assert checkpoint.latest_step(tmp_path) == 5
    out = checkpoint.restore(tmp_path, 5, state)
    assert torch.equal(out["a"], state["a"])
    assert int(out["nested"]["b"]) == 7


def test_checkpoint_keep_n_and_torn_write(tmp_path):
    state = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        checkpoint.save(tmp_path, s, state, keep=2)
    steps = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    # torn checkpoint (no manifest) must be ignored by latest_step
    torn = pathlib.Path(tmp_path) / "step_00000009"
    torn.mkdir()
    assert checkpoint.latest_step(tmp_path) == 4


# -- trainer -----------------------------------------------------------------

W_TRUE = np.array([1.0, -2.0, 0.5, 3.0], np.float32)


def _toy_data(step, microbatches):
    rng = np.random.default_rng(step)
    x = rng.standard_normal((8 * microbatches, 4)).astype(np.float32)
    return x, x @ W_TRUE


def _toy_cfgs(tmp_path, total, fail_at, microbatches, compression):
    cfg = dict(total_steps=total, ckpt_every=10, out_dir=str(tmp_path),
               fail_at_step=fail_at, microbatches=microbatches,
               grad_compression=compression, log_every=5)
    opt = dict(lr=0.05, warmup_steps=0, schedule="constant",
               weight_decay=0.0)
    return cfg, opt


def _init_w(seed):
    """The reference's toy initial weights, ``normal(key, (4,)) * 0.1``."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4,)) * 0.1)


def _mk_trainer(tmp_path, total=30, fail_at=None, microbatches=1,
                compression=False):
    """The reference's ``_mk_trainer`` on the port, starting from the
    reference's initial weights."""
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean()

    def data_fn(step):
        x, y = _toy_data(step, microbatches)
        return {"x": _t(x), "y": _t(y)}

    cfg, opt = _toy_cfgs(tmp_path, total, fail_at, microbatches, compression)
    return Trainer(loss_fn, lambda seed: {"w": _t(_init_w(seed))}, data_fn,
                   TrainerConfig(**cfg), AdamWConfig(**opt))


def _mk_ref_trainer(tmp_path, total=30, microbatches=1, compression=False):
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2)

    def data_fn(step):
        x, y = _toy_data(step, microbatches)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    cfg, opt = _toy_cfgs(tmp_path, total, None, microbatches, compression)
    return JT.Trainer(loss_fn,
                      lambda key: {"w": jax.random.normal(key, (4,)) * 0.1},
                      data_fn, JT.TrainerConfig(**cfg), JO.AdamWConfig(**opt))


def test_trainer_loss_decreases(tmp_path):
    res = _mk_trainer(tmp_path, total=60).run()
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert last < first * 0.5, (first, last)


def test_trainer_crash_resume_equivalence(tmp_path):
    """Crash at step 17, resume from the step-10 checkpoint: the final
    params equal an uninterrupted run's, bit for bit (the reference asks
    rtol 1e-5 of its own)."""
    t1 = _mk_trainer(tmp_path / "a", total=30, fail_at=17)
    with pytest.raises(SimulatedFailure):
        t1.run()
    res_resumed = _mk_trainer(tmp_path / "a", total=30).run()
    assert len(res_resumed["losses"]) == 20          # steps 10..29
    res_clean = _mk_trainer(tmp_path / "b", total=30).run()
    assert torch.equal(res_resumed["state"]["params"]["w"],
                       res_clean["state"]["params"]["w"])
    assert res_resumed["losses"] == res_clean["losses"][10:]


def test_trainer_microbatch_equivalence(tmp_path):
    r1 = _mk_trainer(tmp_path / "m1", total=40, microbatches=1).run()
    r4 = _mk_trainer(tmp_path / "m4", total=40, microbatches=4).run()
    assert np.mean(r1["losses"][-5:]) < np.mean(r1["losses"][:5])
    assert np.mean(r4["losses"][-5:]) < np.mean(r4["losses"][:5])
    assert (pathlib.Path(tmp_path / "m4") / "metrics.jsonl").exists()


def test_trainer_with_compression_converges(tmp_path):
    res = _mk_trainer(tmp_path, total=60, compression=True).run()
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5]) * 0.5


@pytest.mark.parametrize("microbatches,compression",
                         [(1, False), (1, True), (4, False)],
                         ids=["plain", "compressed", "micro4"])
def test_trainer_matches_reference(tmp_path, microbatches, compression):
    """30 steps of the toy trainer in both packages from the same initial
    weights: losses within rtol 1e-5, the logged records alike."""
    ref = _mk_ref_trainer(tmp_path / "ref", 30, microbatches,
                          compression).run()
    got = _mk_trainer(tmp_path / "port", 30, None, microbatches,
                      compression).run()
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["state"]["params"]["w"].numpy(),
                               np.asarray(ref["state"]["params"]["w"]),
                               rtol=1e-5, atol=1e-7)
    logs = [[json.loads(ln) for ln in (tmp_path / side / "metrics.jsonl")
             .read_text().splitlines()] for side in ("ref", "port")]
    assert [sorted(r) for r in logs[0]] == [sorted(r) for r in logs[1]]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]


# -- compression -------------------------------------------------------------

def test_error_feedback_mean_error_vanishes():
    rng = np.random.default_rng(0)
    g = {"w": _t(rng.standard_normal(256))}
    err = init_error_feedback(g)
    total_true = np.zeros(256)
    total_sent = np.zeros(256)
    for _ in range(50):
        total_true += g["w"].numpy()
        sent, err = compress_with_feedback(g, err)
        total_sent += sent["w"].numpy()
    resid = np.abs(total_true - total_sent).max()
    assert resid < 0.1, resid
    assert compression_ratio(g) > 3.5


def test_topk_sparsify_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    np.testing.assert_allclose(topk_sparsify(g, 2).numpy(),
                               [0.0, -5.0, 0.0, 3.0, 0.0])


def test_compression_residual_bounded_every_step():
    rng = np.random.default_rng(1)
    g = {"w": _t(rng.standard_normal((32, 16)))}
    err = init_error_feedback(g)
    for _ in range(20):
        sent, err = compress_with_feedback(g, err)
        assert float(err["w"].abs().max()) < 0.05
        assert sent["w"].shape == g["w"].shape


def test_compression_bf16_cast_error_fed_back():
    rng = np.random.default_rng(3)
    g = {"w": _t(rng.standard_normal(512)).to(torch.bfloat16)}
    err = init_error_feedback(g)
    total_true = np.zeros(512, np.float64)
    total_sent = np.zeros(512, np.float64)
    for _ in range(50):
        total_true += g["w"].double().numpy()
        sent, err = compress_with_feedback(g, err)
        assert sent["w"].dtype == torch.bfloat16
        total_sent += sent["w"].double().numpy()
    assert np.abs(total_true - total_sent).max() < 0.1


def test_compression_sent_plus_error_is_the_gradient():
    """The reference's ``test_compression_is_jittable`` checks, under jit,
    that what is sent plus the new error is the gradient; the port
    compiles nothing, so the identity is checked eagerly."""
    g = {"w": torch.ones(64)}
    sent, new_err = compress_with_feedback(g, init_error_feedback(g))
    np.testing.assert_allclose((sent["w"] + new_err["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)


def test_compression_ratio_scales_with_bits():
    g = {"w": torch.ones(4096)}
    r8 = compression_ratio(g)
    r4 = compression_ratio(g, CompressionConfig(residual_bits=4))
    assert r4 > r8 > 3.5


# -- straggler ---------------------------------------------------------------

def test_straggler_detection_and_rebalance():
    mon = StragglerMonitor(n_workers=8, microbatches_per_worker=4,
                           cfg=StragglerConfig(patience=2, evict_after=50))
    rng = np.random.default_rng(0)
    for step in range(10):
        d = rng.normal(1.0, 0.02, 8)
        d[3] = 3.0
        out = mon.report(step, d)
    assert mon.degraded[3]
    assert out["assignments"][3] == 2
    assert out["assignments"].sum() == 32
    assert out["assignments"][np.argmin(d)] >= 4


def test_straggler_eviction_signal():
    mon = StragglerMonitor(4, 2, StragglerConfig(patience=1, evict_after=5))
    for step in range(10):
        out = mon.report(step, np.array([1.0, 1.0, 1.0, 9.0]))
    assert 3 in out["evict"]


def test_straggler_recovers_after_speedup():
    mon = StragglerMonitor(4, 4, StragglerConfig(patience=2, evict_after=50))
    for step in range(6):
        out = mon.report(step, np.array([1.0, 1.0, 1.0, 4.0]))
    assert mon.degraded[3] and out["assignments"][3] == 2
    for step in range(6, 30):
        out = mon.report(step, np.array([1.0, 1.0, 1.0, 1.0]))
    assert not mon.degraded[3]
    assert out["assignments"][3] == 4
    assert out["assignments"].sum() == 16
    assert out["evict"] == []


def test_straggler_work_conserved_with_many_degraded():
    mon = StragglerMonitor(8, 4, StragglerConfig(patience=1, evict_after=99))
    d = np.ones(8)
    d[[2, 5, 6]] = 10.0
    for step in range(4):
        out = mon.report(step, d)
    assert out["assignments"].sum() == 32
    assert all(out["assignments"][i] == 2 for i in (2, 5, 6))


def test_straggler_matches_reference():
    """The port's copy reports what the reference's does, step by step."""
    from repro.dist.straggler import StragglerConfig as JSC
    from repro.dist.straggler import StragglerMonitor as JSM
    rng = np.random.default_rng(4)
    a = StragglerMonitor(6, 3, StragglerConfig(patience=2, evict_after=4))
    b = JSM(6, 3, JSC(patience=2, evict_after=4))
    for step in range(20):
        d = rng.gamma(2.0, 1.0, 6)
        d[1] *= 3
        x, y = a.report(step, d), b.report(step, d)
        for key in ("assignments", "ewma", "degraded"):
            np.testing.assert_array_equal(x[key], y[key])
        assert x["evict"] == y["evict"]


# -- against the reference ---------------------------------------------------

def _trees(rng):
    """The same nested parameter / gradient trees in both packages."""
    shapes = {"b": {"w": (5, 3), "bias": (3,)}, "a": [(7,), (2, 2)]}

    def draw(scale):
        return {"b": {k: (rng.standard_normal(s) * scale).astype(np.float32)
                      for k, s in shapes["b"].items()},
                "a": [(rng.standard_normal(s) * scale).astype(np.float32)
                      for s in shapes["a"]]}
    return draw(0.5), draw(0.1)


def _to_torch(t):
    return tree.tree_map(lambda a: _t(a, None), t)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_update_and_schedule_match_reference(schedule):
    rng = np.random.default_rng(5)
    p_np, _ = _trees(rng)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=12, schedule=schedule,
               clip_norm=0.5)
    jcfg, tcfg = JO.AdamWConfig(**cfg), AdamWConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jstate = JO.adamw_init(jp)
    assert tree.leaves(adamw_init(_to_torch(p_np))["m"])[0].dtype \
        == torch.float32
    for step in range(12):
        # each step from the same trees: the reference's current state
        tp = _to_torch(jax.tree_util.tree_map(np.asarray, jp))
        tstate = _to_torch(jax.tree_util.tree_map(np.asarray, jstate))
        _, g_np = _trees(rng)
        jp, jstate, jm = JO.adamw_update(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g_np), jstate, jp)
        tp, tstate, tm = adamw_update(tcfg, _to_torch(g_np), tstate, tp)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, atol=1e-9)
        for sub in ("m", "v"):
            for a, b in zip(tree.leaves(tstate[sub]),
                            jax.tree_util.tree_leaves(jstate[sub])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
        for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    for s in range(0, 15):
        np.testing.assert_allclose(
            float(cosine_schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(JO.cosine_schedule(jcfg, jnp.int32(s))),
            rtol=1e-6, atol=1e-9)


def _ulp_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert (np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b)))
            ).all(), np.abs(a - b).max()


def test_compress_with_feedback_matches_reference():
    """Several steps of error feedback on a tree whose leaves hold ties
    in magnitude (k-th and (k+1)-th largest |g| equal, in both signs):
    both packages keep the lower index; sent and error within 1 ulp."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal(256).astype(np.float32)
    w[[10, 50, 90]] = [3.0, -3.0, 3.0]     # k = 4: a three-way tie at 3-4
    w[[3, 200]] = [4.0, -4.0]
    tied = np.round(rng.standard_normal((64, 4)) * 4).astype(np.float32)
    g_np = {"w": w, "t": tied, "s": np.float32(0.25) * np.ones(3, np.float32)}
    j_err = JC.init_error_feedback(jax.tree_util.tree_map(jnp.asarray, g_np))
    t_err = init_error_feedback(_to_torch(g_np))
    for _ in range(4):
        jsent, j_err = JC.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g_np), j_err)
        tsent, t_err = compress_with_feedback(_to_torch(g_np), t_err)
        for a, b in zip(tree.leaves(tsent), jax.tree_util.tree_leaves(jsent)):
            _ulp_close(a.numpy(), b)
        for a, b in zip(tree.leaves(t_err), jax.tree_util.tree_leaves(j_err)):
            _ulp_close(a.numpy(), b)
    kept = topk_sparsify(torch.from_numpy(w), 4).numpy()
    np.testing.assert_array_equal(kept,
                                  np.asarray(JC.topk_sparsify(w, 4)))
    assert kept[10] == 3.0 and kept[50] == 0.0     # the lower index wins
    assert compression_ratio(_to_torch(g_np)) == JC.compression_ratio(g_np)


def test_checkpoints_restore_across_packages(tmp_path):
    """A state written by either package restores in the other: every
    leaf bit-equal, the manifest's paths the same strings."""
    rng = np.random.default_rng(7)
    p_np, _ = _trees(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jstate = {"params": jp, "opt": JO.adamw_init(jp)}
    jstate["opt"]["step"] = jnp.int32(3)
    tp = _to_torch(p_np)
    tstate = {"params": tp, "opt": adamw_init(tp)}
    tstate["opt"]["step"] = torch.tensor(3, dtype=torch.int32)
    JCK.save(tmp_path / "j", 3, jstate)
    checkpoint.save(tmp_path / "t", 3, tstate)
    mj, mt = (json.loads((tmp_path / side / "step_00000003" /
                          "manifest.json").read_text()) for side in "jt")
    assert mj == mt
    assert "['opt']['m']['b']['w']" in mt["paths"]
    from_j = checkpoint.restore(tmp_path / "j", 3, tstate)
    from_t = JCK.restore(tmp_path / "t", 3, jstate)
    for a, b in zip(tree.leaves(from_j), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(from_t), tree.leaves(tstate)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert checkpoint.latest_step(tmp_path / "j") == 3
    assert JCK.latest_step(tmp_path / "t") == 3
