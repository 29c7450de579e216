"""Step factory: (arch x shape) -> the step of a cell.

The port of ``repro.launch.steps``. Train steps: ``make_train_step`` maps
a state {"params", "opt"} and a batch to (state, metrics), AdamW on the
gradients of ``loss_fn``; the losses differentiate through plain torch
attention and bags (``transformer.scores_attention``,
``sparse_ops.gather_embedding_bag``), never through a kernel. Serve steps:
``make_serve_step`` returns, per family: for the LMs, dense and MoE,
prefill (prompt -> last logits and a KV cache) and decode (one token
against the cache); for each recsys model, its ``serve`` step (a batch of
requests, or requests x a shortlist) and its ``retrieval`` step (one
query against a candidate set, top-100), through the kernels.
``state_specs``, ``make_serve_step``'s ``mesh=`` / ``sharded_topk=`` and
the GNN family are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchSpec
from ..configs.shapes import LM_SHAPE_DEFS, RECSYS_SHAPE_DEFS
from ..core.index import resolve_device
from ..models import recsys as R
from ..models import transformer as T
from ..sparse_ops import embedding_bag
from ..train.optimizer import AdamWConfig
from ..train.trainer import train_step

TOPK_SERVE = 100


def _topk(scores, k=TOPK_SERVE):
    """(values, indices) of the k largest scores of the last dim, in
    descending order; ties go to the lower index, as ``lax.top_k``."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = min(k, scores.shape[-1])
    return vals[..., :k], idx[..., :k]


def adapt_config(arch: ArchSpec, shape: str, cfg=None):
    """Per-shape config adjustments (only the GNN family has any)."""
    return cfg if cfg is not None else arch.config()


def init_fn(arch: ArchSpec, shape: str, cfg, device="cuda"):
    """A function of an int seed that returns random parameters on
    ``device``, drawn from a ``torch.Generator`` there."""
    dev = resolve_device(device)
    if arch.family == "lm":
        init = T.init_params
    elif isinstance(cfg, R.DLRMConfig):
        init = R.init_dlrm
    elif isinstance(cfg, R.DINConfig):
        init = R.init_din
    elif isinstance(cfg, R.TwoTowerConfig):
        init = R.init_two_tower
    elif isinstance(cfg, R.Bert4RecConfig):
        init = R.init_bert4rec
    else:
        raise TypeError(type(cfg))
    return lambda seed: init(cfg, torch.Generator(device=dev).manual_seed(
        int(seed)))


def loss_fn(arch: ArchSpec, shape: str, cfg, rules: T.Rules = T.NO_RULES):
    """``(params, batch) -> scalar loss`` of the arch's family."""
    if arch.family == "lm":
        return lambda p, b: T.lm_loss(cfg, p, b, rules)
    if arch.family != "recsys":
        raise NotImplementedError(f"the {arch.family} family is not ported "
                                  f"to repro_torch yet")
    if isinstance(cfg, R.DLRMConfig):
        return lambda p, b: R.dlrm_loss(cfg, p, b, rules)
    if isinstance(cfg, R.DINConfig):
        return lambda p, b: R.din_loss(cfg, p, b, rules)
    if isinstance(cfg, R.TwoTowerConfig):
        return lambda p, b: R.two_tower_loss(cfg, p, b, rules)
    if isinstance(cfg, R.Bert4RecConfig):
        return lambda p, b: R.bert4rec_loss(cfg, p, b, rules)
    raise TypeError(type(cfg))


def make_train_step(arch: ArchSpec, shape: str, cfg,
                    rules: T.Rules = T.NO_RULES,
                    opt_cfg: AdamWConfig | None = None):
    """``step(state, batch) -> (state, metrics)``: the gradients of
    ``loss_fn`` (autograd), then ``adamw_update``; metrics ``loss``,
    ``grad_norm`` and ``lr``. The state's tensors are updated in place.
    (The reference's ``grad_shardings=`` is not ported.)"""
    opt_cfg = opt_cfg or AdamWConfig()
    lfn = loss_fn(arch, shape, cfg, rules)
    return lambda state, batch: train_step(lfn, opt_cfg, state, batch)


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------

def _dlrm_score_candidates(cfg, params, user, cand_ids, rules):
    """One user context x N candidate items (the last sparse field
    varies); the user's 25 fixed fields are one embedding-bag call."""
    n = cand_ids.shape[0]
    cd = cfg.compute_dtype
    bot = R._mlp(params["bot"], user["dense"].to(cd), final_act=True)
    sparse = user["sparse"]                           # [1, 25, multi_hot]
    user_embs = embedding_bag(params["tables"][:cfg.n_sparse - 1].to(cd),
                              sparse, torch.ones(sparse.shape, dtype=cd,
                                                 device=sparse.device))
    cand = params["tables"][cfg.n_sparse - 1][cand_ids.long()].to(cd)
    fixed = torch.cat([bot, user_embs[0]], dim=0)     # [26, D]
    feats = torch.cat([fixed[None].expand(n, *fixed.shape), cand[:, None]],
                      dim=1)                          # [N, 27, D]
    top_in = torch.cat([bot.expand(n, bot.shape[1]),
                        R.dot_interaction(feats)], dim=-1)
    return R._mlp(params["top"], top_in)[:, 0]


def make_serve_step(arch: ArchSpec, shape: str, cfg,
                    rules: T.Rules = T.NO_RULES, *, max_len: int | None = None):
    """The serve step of (arch, shape) for ``cfg``. An LM prefill step
    builds a cache of the cell's sequence length, or of ``max_len`` when
    given (a cut of depth)."""
    if arch.family == "lm":
        kind = LM_SHAPE_DEFS[shape]["kind"]
        if kind == "prefill":
            length = max_len or LM_SHAPE_DEFS[shape]["seq"]

            def step(params, tokens):
                return T.prefill(cfg, params, tokens, length, rules)
            return step
        if kind == "decode":
            def step(params, token, cache, cache_len):
                return T.decode_step(cfg, params, token, cache, cache_len,
                                     rules)
            return step
        raise ValueError(f"no serve step for LM shape {shape}")
    if arch.family != "recsys":
        raise NotImplementedError(f"the {arch.family} family is not ported "
                                  f"to repro_torch yet")
    kind = RECSYS_SHAPE_DEFS[shape]["kind"]
    if kind not in ("serve", "retrieval"):
        raise ValueError(f"no serve step for recsys shape {shape}")
    if isinstance(cfg, R.DLRMConfig):
        if kind == "serve":
            return lambda params, batch: R.dlrm_forward(cfg, params, batch,
                                                        rules)

        def dlrm_retr(params, user, cand_ids):
            s = _dlrm_score_candidates(cfg, params, user, cand_ids, rules)
            vals, idx = _topk(s)
            return vals, cand_ids[idx]
        return dlrm_retr
    if isinstance(cfg, R.DINConfig):
        if kind == "serve":
            return lambda params, batch: R.din_forward(cfg, params, batch,
                                                       rules)

        def din_retr(params, hist, cand_ids):
            n = cand_ids.shape[0]
            batch = {"hist": hist.expand(n, hist.shape[1]),
                     "target": cand_ids}
            vals, idx = _topk(R.din_forward(cfg, params, batch, rules))
            return vals, cand_ids[idx]
        return din_retr
    if isinstance(cfg, R.TwoTowerConfig):
        if kind == "serve":
            def tt_serve(params, user_feats, shortlist):
                u = R.user_encode(cfg, params, user_feats, rules)
                v = R.item_encode(cfg, params, shortlist, rules)
                return u @ v.T
            return tt_serve

        def tt_retr(params, user_feats, cand_emb):
            return _topk(R.two_tower_score_candidates(cfg, params,
                                                      user_feats, cand_emb,
                                                      rules))
        return tt_retr
    if isinstance(cfg, R.Bert4RecConfig):
        if kind == "serve":
            return lambda params, items, cand_ids: R.bert4rec_score_catalog(
                cfg, params, items, cand_ids, rules)

        def b4r_retr(params, items, cand_ids):
            s = R.bert4rec_score_catalog(cfg, params, items, cand_ids,
                                         rules)[0]
            vals, idx = _topk(s)
            return vals, cand_ids[idx]
        return b4r_retr
    raise TypeError(type(cfg))


# --------------------------------------------------------------------------
# smoke batches (small real data for reduced configs)
# --------------------------------------------------------------------------

def smoke_batch(arch: ArchSpec, shape: str, cfg, seed: int = 0,
                device="cuda") -> dict:
    """Small inputs of a cell, drawn by numpy from ``seed`` in the
    reference's order (so both packages get the same integers), as int32
    and float32 tensors on ``device``. A train cell's are under
    ``"batch"``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    f32 = torch.float32
    if arch.family == "lm":
        kind = LM_SHAPE_DEFS[shape]["kind"]
        b, s = 2, 32
        toks = rng.integers(1, cfg.vocab, (b, s + 1))
        if kind == "train":
            return {"batch": {"tokens": t(toks[:, :-1]),
                              "targets": t(toks[:, 1:])}}
        if kind == "prefill":
            return {"tokens": t(toks[:, :-1])}
        cache = T.init_cache(cfg, b, s, dev)
        return {"token": t(toks[:, :1]), "cache": cache, "cache_len": s - 1}
    if arch.family != "recsys":
        raise NotImplementedError(f"the {arch.family} family is not ported "
                                  f"to repro_torch yet")
    kind = RECSYS_SHAPE_DEFS[shape]["kind"]
    b = 8
    if isinstance(cfg, R.DLRMConfig):
        dense = rng.standard_normal((b, cfg.n_dense))
        sparse = rng.integers(0, cfg.vocab_per_field,
                              (b, cfg.n_sparse, cfg.multi_hot))
        feats = {"dense": t(dense, f32), "sparse": t(sparse)}
        if kind == "train":
            return {"batch": {**feats, "label": t(rng.integers(0, 2, b))}}
        if kind == "serve":
            return {"batch": feats}
        return {"user": {"dense": t(dense[:1], f32),
                         "sparse": t(sparse[:1, :cfg.n_sparse - 1])},
                "cand_ids": t(rng.integers(0, cfg.vocab_per_field, 64))}
    if isinstance(cfg, R.DINConfig):
        hist = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
        target = rng.integers(0, cfg.n_items, b)
        base = {"hist": t(hist), "target": t(target)}
        if kind == "train":
            return {"batch": {**base, "label": t(rng.integers(0, 2, b))}}
        if kind == "serve":
            return {"batch": base}
        return {"hist": t(hist[:1]),
                "cand_ids": t(rng.integers(0, cfg.n_items, 64))}
    if isinstance(cfg, R.TwoTowerConfig):
        uf = rng.integers(1, cfg.n_user_feats, (b, cfg.user_bag))
        if kind == "train":
            return {"batch": {
                "user_feats": t(uf),
                "pos_item": t(rng.integers(0, cfg.n_items, b)),
                "neg_items": t(rng.integers(0, cfg.n_items,
                                            cfg.n_negatives)),
                "neg_logq": torch.zeros(cfg.n_negatives, dtype=f32,
                                        device=dev)}}
        if kind == "serve":
            return {"user_feats": t(uf),
                    "shortlist": t(rng.integers(0, cfg.n_items, 32))}
        return {"user_feats": t(uf[:1]),
                "cand_emb": t(rng.standard_normal((128, cfg.tower_mlp[-1])),
                              f32)}
    if isinstance(cfg, R.Bert4RecConfig):
        items = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
        if kind == "train":
            return {"batch": {
                "items": t(items),
                "targets": t(rng.integers(0, cfg.n_items, (b, cfg.seq_len))),
                "mask": t(rng.integers(0, 2, (b, cfg.seq_len))),
                "neg_items": t(rng.integers(0, cfg.n_items, 64))}}
        cand = rng.integers(0, cfg.n_items, 32)
        if kind == "serve":
            return {"items": t(items), "cand_ids": t(cand)}
        return {"items": t(items[:1]), "cand_ids": t(cand)}
    raise TypeError(type(cfg))
