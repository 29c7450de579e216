"""2GTI transferred to dense retrieval (two-tower ``retrieval_cand`` path).

The paper's structure (a cheap model guides two levels of pruning with
independent dynamic thresholds, while an expensive model ranks) maps onto
blocked dense candidate scoring:

- cheap model = dot product over the first ``d_cheap`` dimensions
  (principal subspace; plays BM25's role),
- expensive model = full-dimension dot product (plays the learned model),
- Global level = per-block upper bound of the alpha-combined score from
  coordinate-wise block maxima/minima (block-max analogue) vs theta_Gl,
- Local level = per-candidate cheap score + residual-dim bound (beta
  combination) vs theta_Lo; frozen candidates keep their partial
  (gamma-combined) rank score, which still competes in Q_Rk,
- blocks are visited in descending bound order (impact scheduling).

alpha = beta = gamma recovers exact blocked top-k (rank-safe).

A batch of queries runs as one scan (``_guided_scan``): every row keeps its
own block order and thresholds, and the block loop is a fixed host loop of
``n_blocks`` steps with no read back to the host (the scan has no
data-dependent exit). The products are plain float32 matrix products; on a
GPU they must not run in TF32 (``index.check_full_f32``): TF32 would
move the scores far outside their tolerance.
"""
from __future__ import annotations

import dataclasses

import torch

from .index import check_full_f32, resolve_device
from .traversal import _as_tensor, _f32, _merge_queue, _topk_stable
from .twolevel import TwoLevelParams, resolve_k

TENSOR_FIELDS = ("emb", "bmax", "bmin", "rotation")


@dataclasses.dataclass
class DenseGuidedIndex:
    emb: torch.Tensor       # [N_pad, D] rotated candidate embeddings
    block_size: int
    d_cheap: int
    n_blocks: int
    bmax: torch.Tensor      # [n_blocks, D] coordinate-wise block max
    bmin: torch.Tensor      # [n_blocks, D] coordinate-wise block min
    rotation: torch.Tensor  # [D, D] PCA basis (queries must be rotated too)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def nbytes(self) -> int:
        """Bytes the index's tensors hold on their device."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in TENSOR_FIELDS)

    def to(self, device) -> "DenseGuidedIndex":
        """This index with its tensors on ``device`` (self when already
        there)."""
        dev = resolve_device(device)
        if dev.type == self.device.type and dev.index in (None,
                                                          self.device.index):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in TENSOR_FIELDS})

    def rotate_query(self, q: torch.Tensor) -> torch.Tensor:
        return q @ self.rotation


def build_dense_index(emb, block_size: int = 4096, d_cheap: int = 32,
                      device="cuda") -> DenseGuidedIndex:
    """PCA-rotate so the leading ``d_cheap`` dims carry the most energy:
    the dense analogue of the paper's index *alignment* (the cheap model
    must correlate with the expensive one for its guidance to be safe).
    Dot products are rotation-invariant, so exact scores are unchanged.
    ``emb`` [N, D] (numpy or tensor) is placed on ``device`` as float32."""
    dev = resolve_device(device)
    check_full_f32(dev, "dense retrieval")
    emb = _as_tensor(emb, torch.float32, dev)
    n, d = emb.shape
    cov = (emb.T @ emb) / n
    _, vecs = torch.linalg.eigh(cov)          # ascending eigenvalues
    rot = vecs.flip(1).contiguous()           # descending: PCA basis
    emb = emb @ rot
    pad = (-n) % block_size
    if pad:
        emb = torch.cat([emb, emb.new_zeros((pad, d))])
    nb = emb.shape[0] // block_size
    blocks = emb.view(nb, block_size, d)
    return DenseGuidedIndex(emb=emb, block_size=block_size, d_cheap=d_cheap,
                            n_blocks=nb, bmax=blocks.amax(1),
                            bmin=blocks.amin(1), rotation=rot)


def _bound(q, bmax, bmin):
    """Upper bound of q . x over each block, coordinate-wise: q [B, D],
    bmax/bmin [n_blocks, D] -> [B, n_blocks]."""
    q = q[:, None, :]
    return torch.maximum(q * bmax, q * bmin).sum(-1)


def _guided_scan(index: DenseGuidedIndex, q_rot, params: TwoLevelParams,
                 k: int):
    """Rotated queries [B, D] through the guided block scan. Returns the
    rank queue (values, ids) [B, k] and the fully scored candidates [B]
    (float32)."""
    emb, bs, dc = index.emb, index.block_size, index.d_cheap
    alpha, beta, gamma = (_f32(params.alpha), _f32(params.beta),
                          _f32(params.gamma))
    b, d = q_rot.shape
    dev = emb.device
    qc = q_rot.clone()
    qc[:, dc:] = 0.0
    qr = q_rot.clone()
    qr[:, :dc] = 0.0
    ub_cheap = _bound(qc, index.bmax, index.bmin)      # cheap-score bound
    ub_rest = _bound(qr, index.bmax, index.bmin)       # residual bound
    ub_full = ub_cheap + ub_rest
    ub_alpha = alpha * ub_cheap + (1 - alpha) * ub_full
    order = torch.argsort(-ub_alpha, dim=1, stable=True)   # [B, n_blocks]
    blocks = emb.view(index.n_blocks, bs, d)
    q2 = torch.stack([qc, qr], dim=2)                  # [B, D, 2]
    local = torch.arange(bs, dtype=torch.int32, device=dev)

    def queue():
        return (torch.full((b, k), -torch.inf, dtype=torch.float32,
                           device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    (gv, gi), (lv, li), (rv, ri) = queue(), queue(), queue()
    scored = torch.zeros(b, dtype=torch.float32, device=dev)
    for step in range(index.n_blocks):
        bi = order[:, step:step + 1]                   # [B, 1]
        skip = ub_alpha.gather(1, bi) <= gv[:, -1:]    # vs theta_Gl
        s = torch.bmm(blocks[bi[:, 0]], q2)            # [B, bs, 2]
        s_cheap = s[..., 0]
        # local level: freeze candidates whose beta-combined bound fails
        local_bound = (beta * s_cheap
                       + (1 - beta) * (s_cheap + ub_rest.gather(1, bi)))
        alive = local_bound > lv[:, -1:]               # vs theta_Lo
        s_full = s_cheap + torch.where(alive, s[..., 1], 0.0)
        g = alpha * s_cheap + (1 - alpha) * s_full
        loc = beta * s_cheap + (1 - beta) * s_full
        r = gamma * s_cheap + (1 - gamma) * s_full     # partial if frozen
        ids = bi.to(torch.int32) * bs + local
        live = alive & ~skip
        gv, gi = _merge_queue(gv, gi, torch.where(live, g, -torch.inf),
                              ids, k)
        lv, li = _merge_queue(lv, li, torch.where(live, loc, -torch.inf),
                              ids, k)
        rv, ri = _merge_queue(rv, ri, torch.where(skip, -torch.inf, r),
                              ids, k)
        scored = scored + torch.where(skip[:, 0], 0.0,
                                      alive.sum(1).to(torch.float32))
    return rv, ri, scored


def retrieve_dense_batched(index: DenseGuidedIndex, q,
                           params: TwoLevelParams, k: int | None = None):
    """Batched guided dense retrieval: ``[B, D]`` queries through one scan
    (the serving lane the ``dense`` registry engine uses). Returns numpy
    ``(scores [B, k], ids [B, k], stats)`` with a per-query float32
    ``candidates_fully_scored`` array. Rank-safe configs reduce to the
    exact ``[B, D] @ [N, D]^T`` top-k the blocks implement."""
    check_full_f32(index.device, "dense retrieval")
    q = _as_tensor(q, torch.float32, index.device)
    if q.ndim != 2:
        raise ValueError(f"retrieve_dense_batched takes [B, D] queries, "
                         f"got shape {tuple(q.shape)}")
    rv, ri, scored = _guided_scan(index, q @ index.rotation, params,
                                  resolve_k(params, k))
    stats = {"candidates_fully_scored": scored.cpu().numpy(),
             "n_candidates": float(index.emb.shape[0])}
    return rv.cpu().numpy(), ri.cpu().numpy(), stats


def retrieve_dense(index: DenseGuidedIndex, q, params: TwoLevelParams,
                   k: int | None = None):
    """Top-k candidates for one query ``q`` [D]. Returns (scores, ids,
    stats). ``k`` is the per-call retrieval depth (legacy ``params.k``
    fallback)."""
    check_full_f32(index.device, "dense retrieval")
    q = index.rotate_query(_as_tensor(q, torch.float32, index.device))
    rv, ri, scored = _guided_scan(index, q[None], params,
                                  resolve_k(params, k))
    stats = {"candidates_fully_scored": float(scored[0]),
             "n_candidates": index.emb.shape[0]}
    return rv[0].cpu().numpy(), ri[0].cpu().numpy(), stats


def exhaustive_dense(index: DenseGuidedIndex, q, k: int):
    """Exact top-k of one query over every row of ``index.emb``, the zero
    pad rows included, as the reference computes it."""
    check_full_f32(index.device, "dense retrieval")
    q = _as_tensor(q, torch.float32, index.device)
    vals, ids = _topk_stable(index.emb @ index.rotate_query(q), k)
    return vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy()
