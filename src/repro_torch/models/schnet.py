"""SchNet (Schütt et al., arXiv:1706.08566): continuous-filter convolutions.

The port of ``repro.models.schnet``, over parameter dicts in the
reference's layout (dense layers ``{"w": [in, out], "b": [out]}`` applied
as ``x @ w + b``; the interactions' weights stacked ``[n_interactions,
...]`` under ``"inters"``). Messages are ``x[src] * W(rbf(d_ij))``, summed
into their destination nodes by ``index_add`` (the reference's
``segment_sum``). On the CPU the sum adds edges in order; on CUDA it adds
them atomically, in no fixed order, so a card's results agree with the
CPU's within float32 rounding, not bit for bit.

Two input modes share the interaction trunk:
- ``molecule``: batched small graphs (z [B, N] atom types, edges per
  graph, distances from positions), energy readout (sum-pooled atomwise
  MLP). The batch runs as one graph of B * N nodes (each molecule's edges
  offset by its first node), where the reference maps one molecule at a
  time; the per-molecule energies are the same sums.
- ``graph``: one large graph (node features [N, F] embedded linearly, flat
  edge index + synthetic distances), per-node class logits — used for the
  citation/products/reddit assigned shapes, where SchNet's geometric prior
  is re-based on edge "lengths" supplied by the data pipeline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import as_placed, dim0_placements


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100     # molecule mode vocabulary
    d_feat: int = 0             # >0: graph mode with linear feature embed
    n_out: int = 1              # 1 = energy; >1 = node classes
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    # The reference unrolls its scan over the interactions for dry-run
    # cost probes; eager torch runs them one after another either way, so
    # the field is kept and has no effect.
    unroll: bool = False

    def param_count(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        embed = (self.d_feat * d + d) if self.d_feat else self.n_atom_types * d
        per_inter = (r * d + d) + (d * d + d) + (d * d) + (d * d + d)
        out = d * d + d + d * self.n_out + self.n_out
        return embed + self.n_interactions * per_inter + out


def param_shapes(cfg: SchNetConfig) -> dict:
    """The parameter tree's shapes, as ``init_params`` makes them."""
    d, r, L = cfg.d_hidden, cfg.n_rbf, cfg.n_interactions

    def dense(i, o, lead=()):
        return {"w": (*lead, i, o), "b": (*lead, o)}
    embed = (dense(cfg.d_feat, d) if cfg.d_feat
             else {"w": (cfg.n_atom_types, d)})
    return {"embed": embed,
            "inters": {"filter1": dense(r, d, (L,)),
                       "in2f": {"w": (L, d, d)},
                       "f2out": dense(d, d, (L,)),
                       "post": dense(d, d, (L,))},
            "out1": dense(d, d), "out2": dense(d, cfg.n_out)}


def init_params(cfg: SchNetConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device: dense weights N(0, 1/in),
    biases zero, atom-type embeddings N(0, 0.01)."""
    pt, dev = cfg.param_dtype, gen.device
    d, r = cfg.d_hidden, cfg.n_rbf

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def dense(i, o):
        return {"w": (normal((i, o)) / math.sqrt(i)).to(pt),
                "b": torch.zeros((o,), dtype=pt, device=dev)}

    if cfg.d_feat:
        embed = dense(cfg.d_feat, d)
    else:
        embed = {"w": (normal((cfg.n_atom_types, d)) * 0.1).to(pt)}
    inters = []
    for _ in range(cfg.n_interactions):
        inters.append({
            "filter1": dense(r, d),
            "in2f": {"w": (normal((d, d)) / math.sqrt(d)).to(pt)},
            "f2out": dense(d, d),
            "post": dense(d, d),
        })
    return {"embed": embed,
            "inters": _stack(inters),
            "out1": dense(d, d),
            "out2": dense(d, cfg.n_out)}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree, n: int) -> list:
    """The stacked tree as n trees, each leaf unbound once (its backward
    stacks the n gradients once, where indexing per layer would send a
    full-size gradient back for each use)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _apply(layer, x):
    return x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


def rbf_centres(n_rbf: int, cutoff: float) -> np.ndarray:
    """The reference's centres, ``jnp.linspace(0, cutoff, n_rbf)`` in
    float32, as XLA computes it: centre i is i * fl(fl(1 / (n - 1)) *
    cutoff), the last one ``cutoff``. (``torch.linspace`` rounds 124 of
    the full config's 300 centres otherwise.)"""
    f = np.float32
    if n_rbf == 1:
        return np.zeros(1, f)
    step = f(f(1) / f(n_rbf - 1)) * f(cutoff)
    return np.concatenate([np.arange(n_rbf - 1, dtype=f) * step,
                           [f(cutoff)]]).astype(f)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff]: [E] -> [E, n_rbf]."""
    centres = torch.from_numpy(rbf_centres(n_rbf, cutoff)).to(
        device=dist.device, dtype=dist.dtype)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * torch.square(dist[:, None] - centres[None, :]))


def _rows_at(h, idx):
    """``h[idx]`` (rows of the nodes [N, D] at edge endpoints [E]). With
    DTensors: the node rows gathered whole (an all-gather over the node
    split), each rank reading its own edges' rows; the result is split as
    the edges are."""
    if not isinstance(h, DTensor):
        return h[idx]
    mesh = h.device_mesh
    place = dim0_placements(idx, mesh)
    whole = h.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return DTensor.from_local(whole[as_placed(idx, mesh, place).to_local()],
                              mesh, place, run_check=False)


def _segment_sum(msg, dst, n_nodes: int, like):
    """The messages [E, D] summed into their destination nodes [N, D]
    (``index_add``, the reference's ``segment_sum``). With DTensors: each
    rank adds its own edges' messages into all N rows, and the partial
    sums are reduced over the edge split into the layout of ``like`` (the
    nodes): a reduce-scatter or an all-reduce."""
    if not isinstance(msg, DTensor):
        return torch.zeros((n_nodes, msg.shape[1]), dtype=msg.dtype,
                           device=msg.device).index_add(0, dst, msg)
    mesh = msg.device_mesh
    place = dim0_placements(dst, mesh)
    local = as_placed(msg, mesh, place).to_local()
    agg = torch.zeros((n_nodes, local.shape[1]), dtype=local.dtype,
                      device=local.device).index_add(
        0, as_placed(dst, mesh, place).to_local(), local)
    agg = DTensor.from_local(agg, mesh, [Partial() if p == Shard(0)
                                         else Replicate() for p in place],
                             run_check=False)
    want = (list(like.placements) if isinstance(like, DTensor)
            else [Replicate()] * mesh.ndim)
    return agg.redistribute(mesh, want)


def _interaction(cfg: SchNetConfig, lp: dict, x, src, dst, rbf, n_nodes):
    """cfconv + atomwise post layer. x: [N, D]."""
    w = shifted_softplus(_apply(lp["filter1"], rbf))       # [E, D]
    xs = _rows_at(x @ lp["in2f"]["w"].to(x.dtype), src)    # gather source
    msg = xs * w
    agg = _segment_sum(msg, dst, n_nodes, x)
    h = shifted_softplus(_apply(lp["f2out"], agg))
    h = _apply(lp["post"], h)
    return x + h


def encode(cfg: SchNetConfig, params: dict, nodes, src, dst, dist):
    """Shared trunk. nodes: int [N] (molecule) or float [N, F] (graph)."""
    cd = cfg.compute_dtype
    if cfg.d_feat:
        x = _apply(params["embed"], nodes.to(cd))
    else:
        x = params["embed"]["w"][nodes.long()].to(cd)
    rbf = rbf_expand(dist.to(cd), cfg.n_rbf, cfg.cutoff)
    src, dst = src.long(), dst.long()
    n_nodes = x.shape[0]
    for lp in _unstack(params["inters"], cfg.n_interactions):
        x = _interaction(cfg, lp, x, src, dst, rbf, n_nodes)
    h = shifted_softplus(_apply(params["out1"], x))
    return _apply(params["out2"], h)                       # [N, n_out]


# --------------------------------------------------------------------------
# molecule mode (batched small graphs)
# --------------------------------------------------------------------------

def molecule_energy(cfg: SchNetConfig, params: dict, batch: dict):
    """batch: z [B,N] int (0 = pad), pos [B,N,3], edge_src/dst [B,E] (pad -1).

    Distances are computed from positions. A padded edge becomes an edge
    from atom 0 to atom 0 at distance ``cutoff``: the last RBF centre sits
    at the cutoff, so it still carries weight 1 there and sends a message,
    as the reference's does. Returns per-molecule energies [B].
    """
    z, pos = batch["z"], batch["pos"]
    es, ed = batch["edge_src"].long(), batch["edge_dst"].long()
    b, n = z.shape
    emask = es >= 0
    es_s = torch.where(emask, es, 0)
    ed_s = torch.where(emask, ed, 0)
    rows = torch.arange(b, device=z.device)[:, None]
    flat = pos.reshape(b * n, 3)          # atom (i, j) at row i * n + j
    d = torch.linalg.vector_norm(
        (_rows_at(flat, (es_s + rows * n).reshape(-1))
         - _rows_at(flat, (ed_s + rows * n).reshape(-1))
         + 1e-9).view(b, -1, 3), dim=-1)
    d = torch.where(emask, d, cfg.cutoff)
    off = rows * n                                         # first node of each
    out = encode(cfg, params, z.reshape(-1), (es_s + off).reshape(-1),
                 (ed_s + off).reshape(-1), d.reshape(-1))[:, 0]
    return torch.where(z > 0, out.view(b, n), 0.0).sum(1)


def molecule_loss(cfg: SchNetConfig, params: dict, batch: dict):
    pred = molecule_energy(cfg, params, batch)
    return torch.mean(torch.square(pred - batch["energy"]))


# --------------------------------------------------------------------------
# graph mode (node classification; full-batch or sampled subgraph)
# --------------------------------------------------------------------------

def node_logits(cfg: SchNetConfig, params: dict, batch: dict):
    """batch: x [N,F], edge_src/dst [E], edge_dist [E] -> logits [N, C]."""
    return encode(cfg, params, batch["x"], batch["edge_src"],
                  batch["edge_dst"], batch["edge_dist"])


def node_loss(cfg: SchNetConfig, params: dict, batch: dict):
    logits = node_logits(cfg, params, batch)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("train_mask")
    if mask is None:
        mask = torch.ones(nll.shape, dtype=torch.float32, device=nll.device)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
