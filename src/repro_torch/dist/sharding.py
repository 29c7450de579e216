"""Sharding policy: (family, config, mesh, variant) -> per-dimension specs.

The port of ``repro.dist.sharding``, rule for rule. Where the reference
returns ``NamedSharding`` pytrees, this returns trees of ``P`` specs of
the same structure (a spec says, per tensor dimension, which mesh axes
shard it); ``placements`` turns a spec on a ``DeviceMesh`` into DTensor
placements, and ``train.checkpoint.restore`` places leaves by them.

Two variants are understood everywhere:

- ``"tp"``   — tensor parallelism on the ``model`` axis for weights and
  activations, data parallelism on the ``data`` (and ``pod``) axes for the
  batch.
- ``"fsdp"`` — ZeRO-3 style: parameters and optimizer state sharded over
  *all* mesh axes, activations sharded on batch only, weights gathered
  in compute dtype per layer (``Rules.gather_weights``).

Every rule is divisibility-guarded: a dimension is only sharded when the
axis size divides it, so the same policy holds on any mesh without
per-mesh special cases. Anything unrecognized replicates. The rules read
only a leaf's ``.shape`` (meta tensors will do) and the mesh's axis names
and sizes (``mesh_dim_names``, ``shape``).
"""
from __future__ import annotations

import math

from ..launch.mesh import axis_sizes, dp_axes as _dp_axes
from ..launch.mesh import model_axis as _model_axis


class P(tuple):
    """A per-dimension spec, as the reference's ``PartitionSpec``: entry d
    is None (dim d replicated), a mesh-axis name, or a tuple of names that
    shard dim d together, major to minor (a one-name tuple is that name).
    Prints as ``PartitionSpec(...)``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1


def _rep(ndim: int) -> P:
    return P(*([None] * ndim))


def _shard_dim(shape, dim, axes) -> P:
    spec = [None] * len(shape)
    spec[dim] = axes
    return P(*spec)


def _largest_divisible_dim(shape, size: int, *, reverse: bool = True):
    """Dim index with the largest extent divisible by ``size`` (ties go to
    the trailing dim when ``reverse``), or None."""
    best = None
    dims = range(len(shape) - 1, -1, -1) if reverse else range(len(shape))
    for d in dims:
        if shape[d] % size == 0 and shape[d] > size:
            if best is None or shape[d] > shape[best]:
                best = d
    return best


def _map_named(tree, fn, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts and lists, ``name`` the
    nearest dict key above the leaf (the reference reads the last
    ``DictKey`` of a leaf's path)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, name) for v in tree)
    return fn(name, tree)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where spec entry d names its axis, else ``Replicate()``.
    Axes sharding one dim together must come in the mesh's order (major
    to minor), as DTensor shards a dim over mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for m in order:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[m]} shards two "
                                 f"dims")
            out[m] = Shard(d)
    return tuple(out)


def as_placed(t, mesh, place):
    """``t`` as a DTensor on ``mesh`` laid out as the placements ``place``
    (redistributed where it lies otherwise); a plain tensor is taken as
    whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, place)


def dim0_placements(t, mesh, whole=()) -> list:
    """Placements that keep ``t``'s split of dim 0 on each mesh dim not in
    ``whole`` and nothing else (a plain tensor: whole everywhere)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return [Replicate()] * mesh.ndim
    return [p if p == Shard(0) and m not in whole else Replicate()
            for m, p in enumerate(t.placements)]


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def activation_rules(mesh, variant: str = "tp"):
    """Logical-axis rules (``models.transformer.Rules``) for one mesh.

    tp:   batch -> DP axes, heads/vocab -> model axis.
    fsdp: batch -> DP axes only; weights are gathered per layer in compute
          dtype (no TP activation all-reduces).

    On one card the rules shard nothing; ``dp_size`` is semantics: the MoE
    layer's number of dispatch groups.
    """
    from ..models.transformer import Rules
    dp = _dp_axes(mesh)
    batch = dp if dp else None
    dp_size = _axes_size(mesh, dp)
    if variant == "fsdp":
        return Rules(batch=batch, heads=None, kv_seq=None, vocab=None,
                     dp_size=dp_size, gather_weights=True)
    tp = _model_axis(mesh)
    return Rules(batch=batch, heads=tp, kv_seq=None, vocab=tp,
                 dp_size=dp_size, gather_weights=False)


# --------------------------------------------------------------------------
# parameters / optimizer state
# --------------------------------------------------------------------------

# Leaf-name driven TP placements for the transformer stack. Projections
# shard their head/ffn (output) dim; the return projections shard the
# contraction dim, so each matmul pair needs a single all-reduce
# (Megatron-style column/row split). MoE expert stacks shard the expert
# dim (EP). Stacked-layer leaves carry a leading L dim that stays
# replicated.
_LM_TP_OUT = ("wq", "wk", "wv", "w_gate", "w_up", "router")
_LM_TP_IN = ("wo", "w_down")


def _lm_param_spec(name: str, shape, tp: str, tp_size: int) -> P:
    nd = len(shape)
    if nd <= 1:
        return _rep(nd)
    if name in ("embed", "pos_embed"):
        # [V, D]: shard the vocab/position rows (Rules.vocab == model axis)
        return (_shard_dim(shape, 0, tp) if shape[0] % tp_size == 0
                else _rep(nd))
    if name == "lm_head":
        return (_shard_dim(shape, 1, tp) if shape[1] % tp_size == 0
                else _rep(nd))
    if name in ("w_gate", "w_up", "w_down") and nd == 4:
        # MoE stacks [L, E, D, F]: expert-parallel on the model axis
        return (_shard_dim(shape, 1, tp) if shape[1] % tp_size == 0
                else _rep(nd))
    if name in _LM_TP_OUT:
        return (_shard_dim(shape, nd - 1, tp)
                if shape[-1] % tp_size == 0 else _rep(nd))
    if name in _LM_TP_IN:
        return (_shard_dim(shape, nd - 2, tp)
                if shape[-2] % tp_size == 0 else _rep(nd))
    return _rep(nd)


# Embedding tables dominate recsys parameter bytes; their row dim is
# sharded on the model axis (model-parallel embeddings). MLP weights
# shard their output dim when it divides.
_RECSYS_TABLE_ROWS = 8192  # row count above which dim 0 is table-like


def _recsys_param_spec(name: str, shape, tp: str, tp_size: int) -> P:
    nd = len(shape)
    if nd <= 1:
        return _rep(nd)
    if shape[0] >= _RECSYS_TABLE_ROWS and shape[0] % tp_size == 0:
        return _shard_dim(shape, 0, tp)
    if name == "w" and shape[-1] % tp_size == 0 and shape[-1] > tp_size:
        return _shard_dim(shape, nd - 1, tp)
    return _lm_param_spec(name, shape, tp, tp_size)  # bert4rec reuses the LM


def param_shardings(family: str, cfg, mesh, params, variant: str = "tp"):
    """A tree of ``P`` specs matching ``params`` (tensors, meta tensors or
    anything with ``.shape``).

    tp: family-aware TP placement (see above); gnn replicates — SchNet is
    tiny and rides on pure DP. fsdp: every leaf shards its largest
    divisible dim across all mesh axes (two-axis ZeRO-3 partitioning).
    """
    all_axes = tuple(mesh.mesh_dim_names)
    all_size = _axes_size(mesh, all_axes)
    tp = _model_axis(mesh)
    tp_size = axis_sizes(mesh)[tp] if tp else 1

    def leaf_spec(name, leaf) -> P:
        shape = tuple(leaf.shape)
        if variant == "fsdp":
            d = _largest_divisible_dim(shape, all_size)
            return _shard_dim(shape, d, all_axes) if d is not None \
                else _rep(len(shape))
        if tp is None or family == "gnn":
            return _rep(len(shape))
        if family == "lm":
            return _lm_param_spec(name, shape, tp, tp_size)
        return _recsys_param_spec(name, shape, tp, tp_size)

    return _map_named(params, leaf_spec)


def opt_shardings(p_sh):
    """AdamW state specs from param specs: moments inherit the param
    layout (fp32 copies live where the master param lives); the step
    counter replicates."""
    return {"m": p_sh, "v": p_sh, "step": P()}


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

# Inputs whose leading dim is a candidate/catalog axis: sharded over the
# whole mesh (the retrieval cells score 1M candidates across all devices).
_CANDIDATE_KEYS = ("cand_ids", "cand_emb", "shortlist", "neg_items",
                   "neg_logq")


def input_shardings(family: str, cfg, mesh, spec: dict,
                    variant: str = "tp") -> dict:
    """Per-input ``P`` trees for one input-spec dict (``spec["inputs"]``:
    a tree of leaves with ``.shape``).

    Batch-like leading dims shard over the DP axes; candidate axes shard
    over every mesh axis; KV caches shard their batch dim (dim 1 of
    [L, B, S, Hkv, Dh]); scalars and non-divisible dims replicate.
    """
    dp = _dp_axes(mesh)
    dp_size = _axes_size(mesh, dp)
    all_axes = tuple(mesh.mesh_dim_names)
    all_size = _axes_size(mesh, all_axes)

    def batch_leaf(leaf) -> P:
        shape = tuple(leaf.shape)
        if len(shape) and dp and shape[0] % dp_size == 0 and shape[0] > 1:
            return _shard_dim(shape, 0, dp)
        return _rep(len(shape))

    def cand_leaf(leaf) -> P:
        shape = tuple(leaf.shape)
        if len(shape) and shape[0] % all_size == 0 and shape[0] > all_size:
            return _shard_dim(shape, 0, all_axes)
        return batch_leaf(leaf)

    def cache_leaf(leaf) -> P:
        shape = tuple(leaf.shape)  # [L, B, S, Hkv, Dh] or [L, B, S, Hkv]
        if len(shape) >= 2 and dp and shape[1] % dp_size == 0:
            return _shard_dim(shape, 1, dp)
        return _rep(len(shape))

    def dispatch(name, leaf) -> P:
        if name in _CANDIDATE_KEYS:
            return cand_leaf(leaf)
        return batch_leaf(leaf)

    out = {}
    for key, sub in spec["inputs"].items():
        if key == "cache":
            out[key] = _map_named(sub, lambda _, leaf: cache_leaf(leaf))
        elif key in _CANDIDATE_KEYS:
            out[key] = _map_named(sub, lambda _, leaf: cand_leaf(leaf))
        else:
            out[key] = _map_named(sub, dispatch)
    return out
