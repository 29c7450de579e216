"""Step factory: (arch x shape) -> the step of a cell.

The port of ``repro.launch.steps``. Train steps: ``make_train_step`` maps
a state {"params", "opt"} and a batch to (state, metrics), AdamW on the
gradients of ``loss_fn``; the losses differentiate through plain torch
attention, bags and scatters (``transformer.scores_attention``,
``sparse_ops.gather_embedding_bag``, SchNet's ``index_add``), never
through a kernel. SchNet's cells are train cells only: its molecule cell
trains on energies, its graph cells (``adapt_config`` sets their feature
width and classes) on node labels. Serve steps: ``make_serve_step``
returns, per family: for the LMs, dense and MoE, prefill (prompt -> last
logits and a KV cache) and decode (one token against the cache); for each
recsys model, its ``serve`` step (a batch of requests, or requests x a
shortlist) and its ``retrieval`` step (one query against a candidate set,
top-100), through the kernels. The two-tower retrieval step also runs
over a mesh (``mesh=``, ``sharded_topk=True``): each rank scores its
contiguous slice of the candidates. ``state_specs`` gives the train
state's shapes and dtypes as meta tensors, allocating nothing (the dry
run's arguments).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchSpec
from ..configs.shapes import GNN_SHAPE_DEFS, LM_SHAPE_DEFS, RECSYS_SHAPE_DEFS
from ..core.index import resolve_device
from ..models import recsys as R
from ..models import schnet as S
from ..models import transformer as T
from ..sparse_ops import embedding_bag, take_rows
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.trainer import train_step
from ..tree import tree_map

TOPK_SERVE = 100


def _topk(scores, k=TOPK_SERVE):
    """(values, indices) of the k largest scores of the last dim, in
    descending order; ties go to the lower index, as ``lax.top_k``."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = min(k, scores.shape[-1])
    return vals[..., :k], idx[..., :k]


def adapt_config(arch: ArchSpec, shape: str, cfg=None):
    """Per-shape config adjustments (SchNet graph-mode d_feat/classes)."""
    cfg = cfg if cfg is not None else arch.config()
    if arch.family == "gnn" and shape != "molecule":
        d = GNN_SHAPE_DEFS[shape]
        return dataclasses.replace(cfg, d_feat=d["d_feat"],
                                   n_out=d["classes"])
    return cfg


def init_fn(arch: ArchSpec, shape: str, cfg, device="cuda"):
    """A function of an int seed that returns random parameters on
    ``device``, drawn from a ``torch.Generator`` there."""
    dev = resolve_device(device)
    if arch.family == "lm":
        init = T.init_params
    elif arch.family == "gnn":
        init = S.init_params
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
    if arch.family == "gnn":
        if shape == "molecule":
            return lambda p, b: S.molecule_loss(cfg, p, b)
        return lambda p, b: S.node_loss(cfg, p, b)
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
    cand = take_rows(params["tables"][cfg.n_sparse - 1], cand_ids).to(cd)
    fixed = torch.cat([bot, user_embs[0]], dim=0)     # [26, D]
    feats = torch.cat([fixed[None].expand(n, *fixed.shape), cand[:, None]],
                      dim=1)                          # [N, 27, D]
    top_in = torch.cat([bot.expand(n, bot.shape[1]),
                        R.dot_interaction(feats)], dim=-1)
    return R._mlp(params["top"], top_in)[:, 0]


def _mesh_index(mesh, dims) -> int:
    """This rank's index over the mesh dims ``dims``, read major to
    minor (the order DTensor and the reference's specs shard in)."""
    flat, coord = 0, mesh.get_coordinate()
    for d in dims:
        flat = flat * mesh.shape[d] + coord[d]
    return flat


def _split_dims(x) -> list:
    """The mesh dims over which a DTensor is split (a placement other than
    ``Replicate`` on a dim of more than one rank)."""
    mesh = x.device_mesh
    return [d for d, p in enumerate(x.placements)
            if not p.is_replicate() and mesh.shape[d] > 1]


def _full(x):
    """A DTensor's whole value (gathered, unless no dim is split), or
    ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.full_tensor() if _split_dims(x) else x.to_local()


def _user_vector(cfg, rules, params, user_feats):
    """The two-tower user vector [D] of one request, its parameters
    possibly DTensors: the user table is read where its rows live (the
    bag's ``take_rows``), the tower's weights are gathered (``_full``)."""
    user = {"user_embed": params["user_embed"],
            "user_tower": tree_map(_full, params["user_tower"])}
    return R.user_encode(cfg, user, user_feats, rules)[0]


def _mesh_gather(x, mesh):
    """Every rank's ``x`` concatenated on dim 0 in flat-rank order: stacked
    over the minor axis first, then over each axis above it."""
    from ..dist.collectives import ring_gather_stack
    for dim in reversed(range(mesh.ndim)):
        x = ring_gather_stack(x, mesh.get_group(dim)).flatten(0, 1)
    return x


def _two_tower_sharded_topk(cfg, rules, mesh):
    """The two-tower retrieval step over ``mesh``: rank r (flat, major to
    minor) scores candidate rows [r * n / R, (r + 1) * n / R) against the
    user vector, takes its local top-min(100, n / R), offsets the indices
    by its first row, and every rank merges the gathered lists into the
    global top-100. ``cand_emb`` is the whole [n, D] tensor (each rank
    slices its rows) or a DTensor sharded on dim 0 over every mesh axis
    (its local rows are used); parameters may be DTensors
    (``_user_vector``). Returns what the unsharded step returns on the
    same inputs: values and global row indices, ties to the lower row."""
    from torch.distributed.tensor import DTensor
    n_shards = mesh.size()

    def step(params, user_feats, cand_emb):
        u = _user_vector(cfg, rules, params, _full(user_feats))
        rank = _mesh_index(mesh, range(mesh.ndim))
        n = cand_emb.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} candidates do not split evenly over "
                             f"{n_shards} ranks")
        local_n = n // n_shards
        local = (cand_emb.to_local() if isinstance(cand_emb, DTensor)
                 else cand_emb[rank * local_n:(rank + 1) * local_n])
        if local.shape[0] != local_n:
            raise ValueError(f"rank {rank} holds {local.shape[0]} candidate "
                             f"rows, expected {local_n}")
        v, i = _topk((local.to(u.dtype) @ u).float(),
                     min(TOPK_SERVE, local_n))
        v, i = _mesh_gather(v, mesh), _mesh_gather(i + rank * local_n, mesh)
        tv, ti = _topk(v)
        return tv, i[ti]
    return step


def make_serve_step(arch: ArchSpec, shape: str, cfg,
                    rules: T.Rules = T.NO_RULES, *, max_len: int | None = None,
                    mesh=None, sharded_topk: bool = False):
    """The serve step of (arch, shape) for ``cfg``. An LM prefill step
    builds a cache of the cell's sequence length, or of ``max_len`` when
    given (a cut of depth). With a ``DeviceMesh`` and ``sharded_topk``,
    the two-tower retrieval step scores the candidates sharded over the
    mesh's ranks (``_two_tower_sharded_topk``); otherwise ``mesh`` is not
    used."""
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
    if arch.family == "gnn":
        raise ValueError("GNN cells are train-step cells")
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
        if sharded_topk and mesh is not None:
            return _two_tower_sharded_topk(cfg, rules, mesh)

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


def state_specs(arch: ArchSpec, shape: str, cfg) -> dict:
    """The train state {"params", "opt"} as meta tensors (shapes and dtypes,
    nothing allocated): ``init_fn``'s parameters, drawn on the CPU under a
    ``FakeTensorMode`` (a generator cannot live on the meta device), and
    ``adamw_init``'s tree of them: float32 moments and an int32 step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_fn(arch, shape, cfg, device="cpu")(0)
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), fake)
    return {"params": params, "opt": adamw_init(params)}


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
    if arch.family == "gnn":
        if shape == "molecule":
            b, n, e = 4, 8, 16
            return {"batch": {
                "z": t(rng.integers(1, cfg.n_atom_types, (b, n))),
                "pos": t(rng.standard_normal((b, n, 3)), f32),
                "edge_src": t(rng.integers(0, n, (b, e))),
                "edge_dst": t(rng.integers(0, n, (b, e))),
                "energy": t(rng.standard_normal(b), f32)}}
        nn, ee = 64, 256
        return {"batch": {
            "x": t(rng.standard_normal((nn, cfg.d_feat)), f32),
            "edge_src": t(rng.integers(0, nn, ee)),
            "edge_dst": t(rng.integers(0, nn, ee)),
            "edge_dist": t(rng.random(ee) * cfg.cutoff, f32),
            "labels": t(rng.integers(0, cfg.n_out, nn)),
            "train_mask": torch.ones(nn, dtype=f32, device=dev)}}
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
