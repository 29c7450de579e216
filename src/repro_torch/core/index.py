"""Blocked Impact Index (BII) on a torch device.

The docid space is partitioned into tiles of ``tile_size`` documents. For
each (term, tile) we store a CSR pointer into the term's posting run for that
tile, plus tile-granular maxima of both weights (the block-max analogue).
Query-time gathers are fixed-shape: a term's postings inside one tile are
fetched as a ``pad_len``-wide padded slice.

The layout is built host-side in numpy (``blocked_layout``) and then held
as torch tensors on ``device``: docids and ``tile_ptr`` int32, weights and
maxima float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .align import MergedPostings

# Tensor fields of the index, in declaration order (the bridge and
# ``BlockedImpactIndex.to`` move exactly these).
TENSOR_FIELDS = ("docids", "w_b", "w_l", "tile_ptr", "tile_max_b",
                 "tile_max_l", "sigma_b", "sigma_l")
_INT_FIELDS = ("docids", "tile_ptr")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a usable
    GPU raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class BlockedImpactIndex:
    n_docs: int
    n_terms: int
    tile_size: int
    n_tiles: int
    pad_len: int            # max postings of one term inside one tile (padded)
    # flat postings (term-major, docid-sorted within term)
    docids: torch.Tensor    # [nnz] int32
    w_b: torch.Tensor       # [nnz] f32
    w_l: torch.Tensor       # [nnz] f32
    # per-(term, tile) structure
    tile_ptr: torch.Tensor  # [n_terms, n_tiles + 1] int32 (offsets into flat arrays)
    tile_max_b: torch.Tensor  # [n_terms, n_tiles] f32
    tile_max_l: torch.Tensor  # [n_terms, n_tiles] f32
    # list-level maxima
    sigma_b: torch.Tensor   # [n_terms] f32
    sigma_l: torch.Tensor   # [n_terms] f32
    # docid remapping (identity unless the index was built with doc_order):
    # orig_of_new[new_id] = original docid, or None for identity.
    orig_of_new: np.ndarray | None = None

    @property
    def nnz(self) -> int:
        return int(self.docids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.docids.device

    def nbytes(self) -> int:
        """Bytes the index's tensors hold on their device."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in TENSOR_FIELDS)

    def to(self, device) -> "BlockedImpactIndex":
        """This index with its tensors on ``device`` (self when already
        there)."""
        dev = resolve_device(device)
        if dev.type == self.device.type and dev.index in (None,
                                                          self.device.index):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in TENSOR_FIELDS})

    def to_orig(self, ids: np.ndarray) -> np.ndarray:
        """Map internal docids back to original ids (-1 passes through)."""
        ids = np.asarray(ids)
        if self.orig_of_new is None:
            return ids
        safe = np.clip(ids, 0, self.n_docs - 1)
        return np.where(ids < 0, ids, self.orig_of_new[safe]).astype(ids.dtype)


def impact_doc_order(merged: MergedPostings) -> np.ndarray:
    """Docid reordering by descending total learned mass.

    Clusters high-impact documents into few tiles so tile maxima become
    discriminative — the tile-granular analogue of the docid-reassignment
    (BP reordering) used with block-max indexes in PISA. Returns ``order``
    such that new docid ``i`` is original doc ``order[i]``.
    """
    mass = np.zeros(merged.n_docs, dtype=np.float64)
    np.add.at(mass, merged.docids, merged.w_l.astype(np.float64))
    return np.argsort(-mass, kind="stable").astype(np.int32)


def blocked_layout(merged: MergedPostings, tile_size: int = 2048,
                   pad_multiple: int = 8, pad_cap: int | None = None,
                   doc_order: np.ndarray | None = None) -> dict:
    """Host-side tile layout: a dict of numpy arrays.

    Holds the (optionally reordered) term-major flat postings,
    ``tile_ptr``/``cnt``, exact per-(term, tile) and per-term maxima, and
    ``pad_len``. ``build_index`` moves it onto the device.
    """
    n_docs, n_terms = merged.n_docs, merged.n_terms
    n_tiles = -(-n_docs // tile_size)
    indptr = merged.indptr
    docids = merged.docids
    w_b_arr, w_l_arr = merged.w_b, merged.w_l
    orig_of_new = None
    if doc_order is not None:
        orig_of_new = np.asarray(doc_order, dtype=np.int32)
        new_of_orig = np.empty(n_docs, dtype=np.int32)
        new_of_orig[orig_of_new] = np.arange(n_docs, dtype=np.int32)
        docids = new_of_orig[docids]
        # re-sort each term's postings by the new docid
        term_of = np.repeat(np.arange(n_terms, dtype=np.int64),
                            np.diff(indptr))
        order = np.lexsort((docids, term_of))
        docids = docids[order]
        w_b_arr = w_b_arr[order]
        w_l_arr = w_l_arr[order]

    # tile_ptr[t, tau] = global offset of first posting of term t with
    # docid >= tau * tile_size, from per-(term, tile) counts.
    tile_ptr = np.zeros((n_terms, n_tiles + 1), dtype=np.int32)
    tile_of = (docids.astype(np.int64) // tile_size)
    term_of = np.repeat(np.arange(n_terms, dtype=np.int64), np.diff(indptr))
    # counts[t, tau] = postings of term t in tile tau
    flat = term_of * n_tiles + tile_of
    cnt = np.bincount(flat, minlength=n_terms * n_tiles).reshape(n_terms, n_tiles)
    tile_ptr[:, 1:] = np.cumsum(cnt, axis=1, dtype=np.int64).astype(np.int32)
    tile_ptr += indptr[:n_terms, None].astype(np.int32)

    # per-(term, tile) maxima via max-scatter
    tm_b = np.zeros((n_terms, n_tiles), dtype=np.float32)
    tm_l = np.zeros((n_terms, n_tiles), dtype=np.float32)
    np.maximum.at(tm_b.reshape(-1), flat, w_b_arr)
    np.maximum.at(tm_l.reshape(-1), flat, w_l_arr)

    run_max = int(cnt.max()) if cnt.size else 0
    pad_len = max(pad_multiple, -(-run_max // pad_multiple) * pad_multiple)
    if pad_cap is not None:
        pad_len = min(pad_len, pad_cap)
        if run_max > pad_len:
            raise ValueError(f"pad_cap {pad_cap} < max run {run_max}")

    sigma_b = np.zeros(n_terms, dtype=np.float32)
    sigma_l = np.zeros(n_terms, dtype=np.float32)
    np.maximum.at(sigma_b, term_of, w_b_arr)
    np.maximum.at(sigma_l, term_of, w_l_arr)

    return dict(
        n_docs=n_docs, n_terms=n_terms, tile_size=tile_size, n_tiles=n_tiles,
        pad_len=pad_len, docids=docids.astype(np.int32), w_b=w_b_arr,
        w_l=w_l_arr, tile_ptr=tile_ptr, cnt=cnt, tile_max_b=tm_b,
        tile_max_l=tm_l, sigma_b=sigma_b, sigma_l=sigma_l,
        orig_of_new=orig_of_new)


def index_from_layout(lay: dict, device="cuda") -> BlockedImpactIndex:
    """A ``BlockedImpactIndex`` on ``device`` from layout fields (numpy
    arrays and ints, as ``blocked_layout`` returns them)."""
    dev = resolve_device(device)

    def tensor(name):
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        arr = np.ascontiguousarray(lay[name], dtype=dtype)
        if not arr.flags.writeable:   # torch does not wrap read-only memory
            arr = arr.copy()
        return torch.from_numpy(arr).to(dev)

    orig = lay.get("orig_of_new")
    return BlockedImpactIndex(
        n_docs=int(lay["n_docs"]), n_terms=int(lay["n_terms"]),
        tile_size=int(lay["tile_size"]), n_tiles=int(lay["n_tiles"]),
        pad_len=int(lay["pad_len"]),
        **{f: tensor(f) for f in TENSOR_FIELDS},
        orig_of_new=None if orig is None else np.asarray(orig, np.int32))


def build_index(merged: MergedPostings, tile_size: int = 2048,
                pad_multiple: int = 8, pad_cap: int | None = None,
                doc_order: np.ndarray | None = None,
                device="cuda") -> BlockedImpactIndex:
    """Build the BII from merged postings (host-side numpy) onto ``device``.

    ``doc_order`` (optional): permutation; new docid i <- original
    doc_order[i]. Results are mapped back via ``index.to_orig``.
    """
    resolve_device(device)   # fail before the host build, not after
    lay = blocked_layout(merged, tile_size, pad_multiple, pad_cap, doc_order)
    return index_from_layout(lay, device)


def gather_tile(docids: torch.Tensor, w_b: torch.Tensor, w_l: torch.Tensor,
                tile_ptr: torch.Tensor, q_terms: torch.Tensor,
                tile: torch.Tensor, qw_b: torch.Tensor | None = None,
                qw_l: torch.Tensor | None = None, *, pad_len: int,
                tile_size: int):
    """Fetch padded posting runs of query terms inside tiles.

    ``q_terms`` [..., Nq] and ``tile`` [...] share their leading dims (one
    tile per row: ``[B]`` for a tile step, ``[B, C]`` for a chunk).
    Returns (offs [..., Nq, P] int32 local doc offsets, -1 where padded;
    wb, wl [..., Nq, P] f32 zero-padded). ``qw_b``/``qw_l`` ([..., Nq])
    scale each term's posting weights by the query weight; omitted = raw
    index weights.

    Tile ids past the last tile (the chunk schedule's sentinel) are
    clamped, so their runs come back empty, as the reference's clipped
    gathers give them.
    """
    n_tiles = tile_ptr.shape[1] - 1
    qt = q_terms.long()
    t = tile.long().clamp(0, n_tiles)[..., None]
    start = tile_ptr[qt, t]                                 # [..., Nq]
    cnt = tile_ptr[qt, (t + 1).clamp(max=n_tiles)] - start  # [..., Nq]
    ar = torch.arange(pad_len, dtype=torch.int32, device=tile_ptr.device)
    mask = ar < cnt[..., None]
    idx = torch.where(mask, start[..., None] + ar, 0).long()
    base = tile.to(torch.int32)[..., None, None] * tile_size
    offs = torch.where(mask, docids[idx] - base, -1)
    wb = torch.where(mask, w_b[idx], 0.0)
    wl = torch.where(mask, w_l[idx], 0.0)
    if qw_b is not None:
        wb = wb * qw_b[..., None]
    if qw_l is not None:
        wl = wl * qw_l[..., None]
    return offs.to(torch.int32), wb, wl
