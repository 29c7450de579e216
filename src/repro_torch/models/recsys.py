"""RecSys architectures: DLRM, DIN, two-tower retrieval, BERT4Rec.

The port of ``repro.models.recsys``, over parameter dicts in the
reference's layout (MLP layers as lists of ``{"w": [in, out], "b":
[out]}``, applied as ``x @ w + b``). Embedding bags are an argument
(``bag=``) of the forwards that take them: serving takes the default,
``sparse_ops.embedding_bag`` (the hand-written kernel on CUDA tensors;
DLRM looks up all its fields in one call over the stacked ``[F, V, D]``
tables); the training losses pass ``sparse_ops.gather_embedding_bag``,
which autograd differentiates (the kernel has no backward). BERT4Rec runs
the transformer bidirectionally: serving through the flash-attention
kernel with ``causal=False``, its loss through ``scores_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..sparse_ops import embedding_bag, gather_embedding_bag, take_rows
from .transformer import (NO_RULES, Rules, TransformerConfig, forward,
                          init_params as init_tf_params, scores_attention)


def _mlp_init(gen, dims, pt):
    dev = gen.device
    layers = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = torch.randn((i, o), generator=gen, device=dev)
        layers.append({"w": w.mul_((2.0 / (i + o)) ** 0.5).to(pt),
                       "b": torch.zeros((o,), dtype=pt, device=dev)})
    return layers


def _mlp(layers, x, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if final_act or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _mlp_params(dims):
    return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))


def _normal(gen, shape, std, pt):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std).to(
        pt)


def _unit_rows(x):
    """Rows scaled to unit norm. A DTensor split on its last dim is
    gathered there first: the norm's backward writes in place, which
    DTensor refuses on a partial sum."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(x.dim() - 1) or p.is_partial() else p
            for p in x.placements])
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-6)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091), RM-2 scale
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_field: int = 1_000_000
    bot_mlp: tuple = (13, 512, 256, 64)
    top_mlp_hidden: tuple = (512, 512, 256, 1)
    multi_hot: int = 1          # lookups per field (EmbeddingBag when > 1)
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_count(self) -> int:
        n_inter = self.n_sparse + 1
        d_inter = n_inter * (n_inter - 1) // 2 + self.embed_dim
        return (self.n_sparse * self.vocab_per_field * self.embed_dim
                + _mlp_params(self.bot_mlp)
                + _mlp_params((d_inter,) + self.top_mlp_hidden))


def init_dlrm(cfg: DLRMConfig, gen: torch.Generator) -> dict:
    pt = cfg.param_dtype
    tables = _normal(gen, (cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim),
                     0.01, pt)
    n_inter = cfg.n_sparse + 1
    d_inter = n_inter * (n_inter - 1) // 2 + cfg.embed_dim
    return {"tables": tables,
            "bot": _mlp_init(gen, list(cfg.bot_mlp), pt),
            "top": _mlp_init(gen, [d_inter] + list(cfg.top_mlp_hidden), pt)}


def dot_interaction(feats):
    """The pairwise dot products of ``feats`` [B, N, D] above the diagonal,
    [B, N(N-1)/2], in row-major (i < j) order, as ``jnp.triu_indices``."""
    n = feats.shape[1]
    inter = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
    return inter[:, iu, ju]


def dlrm_forward(cfg: DLRMConfig, params: dict, batch: dict,
                 rules: Rules = NO_RULES, *, bag=None):
    """batch: dense [B, 13] f32, sparse [B, 26, multi_hot] int -> [B]. The
    26 fields' bags are one ``bag`` call over the stacked tables (None:
    ``embedding_bag``, the kernel)."""
    bag = bag or embedding_bag
    cd = cfg.compute_dtype
    bot = _mlp(params["bot"], batch["dense"].to(cd), final_act=True)  # [B, D]
    sparse = batch["sparse"]
    embs = bag(params["tables"].to(cd), sparse,
               torch.ones(sparse.shape, dtype=cd,
                          device=sparse.device))                # [B, 26, D]
    feats = torch.cat([bot[:, None, :], embs], dim=1)            # [B, 27, D]
    feats = rules.c(feats, (rules.batch, None, None))
    top_in = torch.cat([bot, dot_interaction(feats)], dim=-1)
    return _mlp(params["top"], top_in)[:, 0]


def _bce_with_logits(logit, label):
    """The reference's mean binary cross-entropy of logits: max(z, 0) -
    z y + log1p(exp(-|z|))."""
    y = label.float()
    return (torch.clamp_min(logit, 0) - logit * y
            + torch.log1p(torch.exp(-logit.abs()))).mean()


def dlrm_loss(cfg: DLRMConfig, params: dict, batch: dict,
              rules: Rules = NO_RULES):
    return _bce_with_logits(
        dlrm_forward(cfg, params, batch, rules, bag=gather_embedding_bag),
        batch["label"])


# ---------------------------------------------------------------------------
# DIN (arXiv:1706.06978)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DINConfig:
    embed_dim: int = 18
    seq_len: int = 100
    n_items: int = 200_000
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_count(self) -> int:
        d = self.embed_dim
        return (self.n_items * d
                + _mlp_params((4 * d,) + self.attn_mlp + (1,))
                + _mlp_params((2 * d,) + self.mlp + (1,)))


def init_din(cfg: DINConfig, gen: torch.Generator) -> dict:
    pt = cfg.param_dtype
    return {
        "items": _normal(gen, (cfg.n_items, cfg.embed_dim), 0.01, pt),
        "attn": _mlp_init(gen, [4 * cfg.embed_dim, *cfg.attn_mlp, 1], pt),
        "mlp": _mlp_init(gen, [2 * cfg.embed_dim, *cfg.mlp, 1], pt),
    }


def din_forward(cfg: DINConfig, params: dict, batch: dict,
                rules: Rules = NO_RULES):
    """batch: hist [B, L] int (0 pad), target [B] int -> logits [B]."""
    cd = cfg.compute_dtype
    hist = take_rows(params["items"], batch["hist"]).to(cd)
    tgt = take_rows(params["items"], batch["target"]).to(cd)
    tgt_b = tgt[:, None, :].expand_as(hist)
    att_in = torch.cat([hist, tgt_b, hist * tgt_b, hist - tgt_b], dim=-1)
    scores = _mlp(params["attn"], att_in)[..., 0]                # [B, L]
    scores = scores.masked_fill(~(batch["hist"] > 0), -1e30)
    w = torch.softmax(scores, dim=-1)
    user = torch.einsum("bl,bld->bd", w, hist)
    x = rules.c(torch.cat([user, tgt], dim=-1), (rules.batch, None))
    return _mlp(params["mlp"], x)[:, 0]


def din_loss(cfg: DINConfig, params: dict, batch: dict,
             rules: Rules = NO_RULES):
    return _bce_with_logits(din_forward(cfg, params, batch, rules),
                            batch["label"])


# ---------------------------------------------------------------------------
# Two-tower retrieval (YouTube RecSys'19 style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    n_user_feats: int = 500_000
    n_items: int = 2_000_000
    user_bag: int = 16          # multi-hot user history bag size
    feat_dim: int = 128         # embedding dim feeding the towers
    n_negatives: int = 1024     # sampled softmax negatives (training)
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_count(self) -> int:
        return (self.n_user_feats * self.feat_dim
                + self.n_items * self.feat_dim
                + _mlp_params((self.feat_dim,) + self.tower_mlp) * 2)


def init_two_tower(cfg: TwoTowerConfig, gen: torch.Generator) -> dict:
    pt = cfg.param_dtype
    return {
        "user_embed": _normal(gen, (cfg.n_user_feats, cfg.feat_dim), 0.02,
                              pt),
        "item_embed": _normal(gen, (cfg.n_items, cfg.feat_dim), 0.02, pt),
        "user_tower": _mlp_init(gen, [cfg.feat_dim, *cfg.tower_mlp], pt),
        "item_tower": _mlp_init(gen, [cfg.feat_dim, *cfg.tower_mlp], pt),
    }


def user_encode(cfg: TwoTowerConfig, params: dict, user_feats,
                rules: Rules = NO_RULES, *, bag=None):
    """Unit user vectors [B, D] from the mean of each user's bag (id 0 is
    padding), taken by ``bag`` (None: ``embedding_bag``, the kernel)."""
    bag = bag or embedding_bag
    cd = cfg.compute_dtype
    mean = bag(params["user_embed"].to(cd), user_feats,
               (user_feats > 0).to(cd), mode="mean")
    return _unit_rows(_mlp(params["user_tower"], mean))


def item_encode(cfg: TwoTowerConfig, params: dict, item_ids,
                rules: Rules = NO_RULES):
    cd = cfg.compute_dtype
    e = take_rows(params["item_embed"], item_ids).to(cd)
    return _unit_rows(_mlp(params["item_tower"], e))


def two_tower_loss(cfg: TwoTowerConfig, params: dict, batch: dict,
                   rules: Rules = NO_RULES):
    """Sampled softmax with shared negatives and logQ correction. batch:
    user_feats [B, bag], pos_item [B], neg_items [N], neg_logq [N]."""
    u = user_encode(cfg, params, batch["user_feats"], rules,
                    bag=gather_embedding_bag)                    # [B, D]
    pos = item_encode(cfg, params, batch["pos_item"], rules)     # [B, D]
    neg = item_encode(cfg, params, batch["neg_items"], rules)    # [N, D]
    u = rules.c(u, (rules.batch, None))
    temp = 20.0
    s_pos = (u * pos).sum(-1) * temp                             # [B]
    s_neg = u @ neg.T * temp - batch["neg_logq"][None, :]        # [B, N]
    logits = torch.cat([s_pos[:, None], s_neg], dim=1)
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def two_tower_score_candidates(cfg: TwoTowerConfig, params: dict,
                               user_feats, cand_emb, rules: Rules = NO_RULES):
    """Bulk-score 1 query against precomputed candidate tower outputs
    ``cand_emb`` [N_cand, D]. Returns float32 scores [N_cand]."""
    u = user_encode(cfg, params, user_feats, rules)              # [1, D]
    return (cand_emb.to(u.dtype) @ u[0]).float()


# ---------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690) — reuses the transformer, bidirectional
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    n_items: int = 50_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    unroll: bool = False

    def tf_config(self) -> TransformerConfig:
        return TransformerConfig(
            n_layers=self.n_blocks, d_model=self.embed_dim,
            n_heads=self.n_heads, n_kv_heads=self.n_heads,
            d_ff=4 * self.embed_dim, vocab=self.n_items + 2,  # +pad +mask
            causal=False, rope=False, max_position=self.seq_len,
            tie_embeddings=True, compute_dtype=self.compute_dtype,
            param_dtype=self.param_dtype, remat=False, unroll=self.unroll)

    def param_count(self) -> int:
        return self.tf_config().param_count()


def init_bert4rec(cfg: Bert4RecConfig, gen: torch.Generator) -> dict:
    return init_tf_params(cfg.tf_config(), gen)


def bert4rec_loss(cfg: Bert4RecConfig, params: dict, batch: dict,
                  rules: Rules = NO_RULES):
    """Masked-item prediction with sampled softmax: items/targets/mask
    [B, S] and shared negatives ``neg_items`` [N] (a full softmax over a
    1M-item catalog would hold [B, S, V] logits)."""
    hidden, _, _ = forward(cfg.tf_config(), params, batch["items"], rules,
                           attention=scores_attention)
    emb = params["embed"].to(hidden.dtype)
    pos_e = take_rows(emb, batch["targets"])                     # [B, S, D]
    pos = torch.einsum("bsd,bsd->bs", hidden, pos_e)
    neg_e = take_rows(emb, batch["neg_items"])                   # [N, D]
    neg = hidden.float() @ neg_e.float().T                       # [B, S, N]
    lse = torch.logaddexp(pos.float(), torch.logsumexp(neg, dim=-1))
    nll = lse - pos
    mask = batch["mask"].float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def bert4rec_score_catalog(cfg: Bert4RecConfig, params: dict, items,
                           cand_ids, rules: Rules = NO_RULES):
    """Next-item scores of candidate ids for each sequence: [B, N_cand]
    float32 (both factors widened to float32, which is the reference's
    compute-dtype product with float32 accumulation)."""
    hidden, _, _ = forward(cfg.tf_config(), params, items, rules)
    state = hidden[:, -1, :]                                     # [B, D]
    cand = take_rows(params["embed"], cand_ids).to(state.dtype)
    return state.float() @ cand.float().T
