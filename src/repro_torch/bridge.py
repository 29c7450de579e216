"""Carry state built by the JAX package over to the port.

The retrieval core's state is the index. ``index_from_arrays`` takes the
fields of the reference's ``BlockedImpactIndex`` as numpy arrays (and ints)
and returns the port's index on ``device``, so both packages search the
same arrays; ``compressed_from_arrays`` does the same for the reference's
``CompressedImpactIndex``, ``dense_index_from_arrays`` for its
``DenseGuidedIndex`` (so parity tests search the reference's PCA basis:
eigenvector signs, and the order of near-equal eigenvalues, differ between
``jnp.linalg.eigh`` and ``torch.linalg.eigh``), and
``hybrid_index_from_arrays`` for its ``HybridIndex``. The port never imports the reference; callers
convert, e.g. ``{f.name: np.asarray(getattr(idx, f.name)) for f in
dataclasses.fields(idx)}``.

The models' state is their parameters. ``transformer_params_from_arrays``,
``recsys_params_from_arrays`` and ``schnet_params_from_arrays`` take the
reference's parameter tree with
numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and return
the port's: the port keeps the reference's layout (layers stacked
``[L, ...]``, weights applied as ``x @ W``, MLP layers as lists of
``{"w", "b"}``), so every tensor is an exact copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import dense_guided
from .core.dense_guided import DenseGuidedIndex
from .core.index import (TENSOR_FIELDS, BlockedImpactIndex, index_from_layout,
                         resolve_device)
from .index.compressed import index_from_fields
from .retrieval.hybrid import HybridIndex
from .models import schnet as S
from .models import transformer as T

SCALAR_FIELDS = ("n_docs", "n_terms", "tile_size", "n_tiles", "pad_len")


def index_from_arrays(fields: dict[str, np.ndarray],
                      device="cuda") -> BlockedImpactIndex:
    """The port's ``BlockedImpactIndex`` on ``device`` from the reference
    index's fields. Docids and ``tile_ptr`` become int32, weights and
    maxima float32; ``orig_of_new`` (optional) stays a host array."""
    missing = [f for f in SCALAR_FIELDS + TENSOR_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")
    lay = {f: int(np.asarray(fields[f])) for f in SCALAR_FIELDS}
    lay.update({f: np.asarray(fields[f]) for f in TENSOR_FIELDS})
    orig = fields.get("orig_of_new")
    lay["orig_of_new"] = None if orig is None else np.asarray(orig)
    return index_from_layout(lay, device)


# The port's CompressedImpactIndex on ``device`` from the reference
# compressed index's fields (numpy arrays in its dtypes, and ints):
# ``packed`` becomes a bitcast int32, ``first`` int32, the rest keeps its
# dtype; ``orig_of_new`` (optional) stays a host array.
compressed_from_arrays = index_from_fields

DENSE_SCALAR_FIELDS = ("block_size", "d_cheap", "n_blocks")


def dense_index_from_arrays(fields: dict, device="cuda") -> DenseGuidedIndex:
    """The port's ``DenseGuidedIndex`` on ``device`` from the reference's
    built one: ``emb``, ``bmax``, ``bmin``, ``rotation`` as numpy arrays
    (float32) and the ints ``block_size``, ``d_cheap``, ``n_blocks``."""
    dev = resolve_device(device)
    missing = [f for f in DENSE_SCALAR_FIELDS + dense_guided.TENSOR_FIELDS
               if f not in fields]
    if missing:
        raise KeyError(f"dense index fields missing: {missing}")
    return DenseGuidedIndex(
        **{f: int(np.asarray(fields[f])) for f in DENSE_SCALAR_FIELDS},
        **{f: torch.from_numpy(np.array(fields[f], np.float32)).to(dev)
           for f in dense_guided.TENSOR_FIELDS})


def hybrid_index_from_arrays(sparse_fields: dict, dense_fields: dict,
                             q_proj, device="cuda") -> HybridIndex:
    """The port's ``HybridIndex`` on ``device`` from the reference's: the
    sparse side's fields (an fp32 ``BlockedImpactIndex``'s, or a
    ``CompressedImpactIndex``'s, told apart by ``packed``), the dense
    side's (``dense_index_from_arrays``) and ``q_proj`` [n_terms, D]."""
    sparse = (compressed_from_arrays(sparse_fields, device)
              if "packed" in sparse_fields
              else index_from_arrays(sparse_fields, device))
    q_proj = torch.from_numpy(np.array(q_proj, np.float32))
    return HybridIndex(sparse=sparse,
                       dense=dense_index_from_arrays(dense_fields, device),
                       q_proj=q_proj.to(resolve_device(device)))


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def transformer_params_from_arrays(cfg: T.TransformerConfig, tree: dict,
                                   device="cuda") -> dict:
    """The port's transformer parameters on ``device`` from the reference's
    tree of numpy arrays; raises unless its shapes are ``cfg``'s."""
    params = _tree_to_torch(tree, resolve_device(device))
    want = {k: (v if isinstance(v, dict) else tuple(v))
            for k, v in T.param_shapes(cfg).items()}
    if _shapes(params) != want:
        raise ValueError(f"parameter shapes {_shapes(params)} are not those "
                         f"of the config: {want}")
    return params


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return tree.numel()


def schnet_params_from_arrays(cfg: S.SchNetConfig, tree: dict,
                              device="cuda") -> dict:
    """The port's SchNet parameters on ``device`` from the reference's tree
    of numpy arrays (interactions stacked under ``"inters"``); raises
    unless its shapes are ``cfg``'s and it holds ``cfg.param_count()``
    values."""
    params = _tree_to_torch(tree, resolve_device(device))
    if _shapes(params) != S.param_shapes(cfg):
        raise ValueError(f"parameter shapes {_shapes(params)} are not those "
                         f"of the config: {S.param_shapes(cfg)}")
    if _count(params) != cfg.param_count():
        raise ValueError(f"{_count(params)} parameters, the config has "
                         f"{cfg.param_count()}")
    return params


def recsys_params_from_arrays(cfg, tree: dict, device="cuda") -> dict:
    """The port's parameters of a recsys model (DLRM, DIN, two-tower or
    BERT4Rec config ``cfg``) on ``device`` from the reference's tree of
    numpy arrays; raises unless they hold ``cfg.param_count()`` values."""
    params = _tree_to_torch(tree, resolve_device(device))
    if _count(params) != cfg.param_count():
        raise ValueError(f"{_count(params)} parameters, the config has "
                         f"{cfg.param_count()}")
    return params
