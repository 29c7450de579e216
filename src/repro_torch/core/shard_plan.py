"""Tile-range sharding of the impact index for sharded retrieval.

The docid space is partitioned into ``n_shards`` *contiguous tile ranges*
(tiles are already independent scan units, so a range of them is a fully
self-contained mini-index). For each shard the host build re-packs the
term-major posting runs that fall inside its range, rebases docids to the
shard-local space (docid - shard_start_tile * tile_size) and rebases
``tile_ptr`` into the shard's flat arrays. All shards are padded to one
static shape (``tiles_per_shard`` tiles, ``max_nnz`` postings) and
stacked on a leading shard axis; ``ShardedImpactIndex.shard(s)`` views
shard ``s`` as an ordinary index, so the single-device executors run it
unchanged.

Both index kinds shard: the fp32 ``BlockedImpactIndex`` and the
``repro_torch.index.CompressedImpactIndex``. The posting payload is
carried as the index's ``gather_arrays()`` tuple with every leaf stacked
on the shard axis (``gather_kind`` tags the layout). Compressed runs need
no value rebase (delta gaps and the per-run first offset are tile-local),
so sharding only rebases the two CSR pointer grids (``tile_ptr`` at
posting granularity, ``pack_ptr`` at word granularity; runs are
word-aligned, so word spans concatenate without re-packing) and slices
the per-(term, tile) metadata columns.

List-level maxima (``sigma_b``/``sigma_l``) stay *global* and replicated:
every shard must sort query terms in the same order or the MaxScore
partition, and therefore the results, would diverge between shard counts.

Padded tiles (when ``n_shards`` does not divide ``n_tiles``) carry zero
postings and zero block maxima; they survive nothing and contribute only
-inf candidates, which lose stable-tie merges against real entries.

The repack runs in numpy on the host: the source index is read to the
host once, wherever it lives, and the stacked result is placed on
``device`` (``"cuda"`` by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index import BlockedImpactIndex, resolve_device

_FP32_LEAVES = ("docids", "w_b", "w_l", "tile_ptr")
_Q8_LEAVES = ("packed", "qb", "ql", "tile_ptr", "pack_ptr", "width",
              "first", "scale_b", "zero_b", "scale_l", "zero_l")
_FLAT_SLOTS = (0, 1, 2)   # per-posting (per-word) leaves in both layouts


@dataclasses.dataclass
class ShardedImpactIndex:
    """Stacked per-shard view of a blocked index (leading dim = shard)."""
    n_shards: int
    n_docs: int
    n_terms: int
    tile_size: int
    n_tiles: int            # real (unpadded) global tile count
    tiles_per_shard: int    # padded: n_shards * tiles_per_shard >= n_tiles
    pad_len: int
    doc_base: torch.Tensor     # [n_shards] int32 first internal docid
    n_real_tiles: torch.Tensor  # [n_shards] int32 real tiles (rest padding)
    nnz_per_shard: np.ndarray
    # posting payload: the source index's gather_arrays() tuple, every
    # leaf stacked on a leading shard axis and padded to a common shape
    gather: tuple
    gather_kind: str        # "fp32" | "q8"
    tile_max_b: torch.Tensor   # [n_shards, n_terms, tiles_per_shard] f32
    tile_max_l: torch.Tensor   # [n_shards, n_terms, tiles_per_shard] f32
    sigma_b: torch.Tensor      # [n_terms] f32, global, replicated
    sigma_l: torch.Tensor      # [n_terms] f32, global, replicated
    orig_of_new: np.ndarray | None = None

    def _fp32_leaf(self, i: int) -> torch.Tensor:
        if self.gather_kind != "fp32":
            raise AttributeError(
                "flat fp32 posting views are only defined for "
                f"gather_kind='fp32' (this index is {self.gather_kind!r})")
        return self.gather[i]

    # fp32 back-compat views (the reference's pre-gather-tuple names)
    @property
    def docids(self) -> torch.Tensor:
        return self._fp32_leaf(0)

    @property
    def w_b(self) -> torch.Tensor:
        return self._fp32_leaf(1)

    @property
    def w_l(self) -> torch.Tensor:
        return self._fp32_leaf(2)

    @property
    def tile_ptr(self) -> torch.Tensor:
        return self.gather[3]  # same slot in both layouts

    @property
    def device(self) -> torch.device:
        return self.tile_max_b.device

    @property
    def max_nnz(self) -> int:
        """Postings each shard is padded to (the flat leaves' length)."""
        return int(self.gather[1].shape[1])

    def n_real(self, s: int) -> int:
        """Real tiles of shard ``s`` (host arithmetic: no device read)."""
        return int(np.clip(self.n_tiles - self.tiles_per_shard * s, 0,
                           self.tiles_per_shard))

    def base(self, s: int) -> int:
        """First internal docid of shard ``s`` (host arithmetic)."""
        return min(s * self.tiles_per_shard, self.n_tiles) * self.tile_size

    def _tensors(self) -> tuple:
        return (*self.gather, self.doc_base, self.n_real_tiles,
                self.tile_max_b, self.tile_max_l, self.sigma_b, self.sigma_l)

    def nbytes(self) -> dict:
        """Bytes on the device: ``total``; ``per_shard``, what one shard's
        slice of the stacked tensors holds (padding included);
        ``replicated``, the global list maxima every shard reads."""
        rep = sum(t.numel() * t.element_size()
                  for t in (self.sigma_b, self.sigma_l))
        total = sum(t.numel() * t.element_size() for t in self._tensors())
        return {"total": total, "replicated": rep,
                "per_shard": (total - rep) // self.n_shards}

    def to(self, device) -> "ShardedImpactIndex":
        """This index with its tensors on ``device`` (self when already
        there)."""
        dev = resolve_device(device)
        if dev.type == self.device.type and dev.index in (None,
                                                          self.device.index):
            return self
        return dataclasses.replace(
            self, gather=tuple(t.to(dev) for t in self.gather),
            **{f: getattr(self, f).to(dev) for f in (
                "doc_base", "n_real_tiles", "tile_max_b", "tile_max_l",
                "sigma_b", "sigma_l")})

    def shard(self, s: int):
        """Shard ``s`` as a ``BlockedImpactIndex`` (fp32) or
        ``CompressedImpactIndex`` (q8) over its ``tiles_per_shard`` tiles
        and shard-local docids: views of the stacked tensors (no copy),
        the global ``sigma_b``/``sigma_l``, no docid remapping. Padded
        tiles are ordinary empty tiles of the view; callers force-skip
        them (``n_real``)."""
        if not 0 <= s < self.n_shards:
            raise IndexError(f"shard {s} of {self.n_shards}")
        leaves = tuple(t[s] for t in self.gather)
        geom = dict(n_docs=self.tiles_per_shard * self.tile_size,
                    n_terms=self.n_terms, tile_size=self.tile_size,
                    n_tiles=self.tiles_per_shard, pad_len=self.pad_len,
                    tile_max_b=self.tile_max_b[s],
                    tile_max_l=self.tile_max_l[s], sigma_b=self.sigma_b,
                    sigma_l=self.sigma_l, orig_of_new=None)
        if self.gather_kind == "fp32":
            return BlockedImpactIndex(**geom,
                                      **dict(zip(_FP32_LEAVES, leaves)))
        # imported here: repro_torch.index imports repro_torch.core
        from ..index.compressed import CompressedImpactIndex
        return CompressedImpactIndex(**geom, nnz=int(self.nnz_per_shard[s]),
                                     **dict(zip(_Q8_LEAVES, leaves)))

    def to_orig(self, ids: np.ndarray) -> np.ndarray:
        """Map internal docids back to original ids (-1 passes through)."""
        ids = np.asarray(ids)
        if self.orig_of_new is None:
            return ids
        safe = np.clip(ids, 0, self.n_docs - 1)
        return np.where(ids < 0, ids, self.orig_of_new[safe]).astype(ids.dtype)


def _csr_shard_gather(h_ptr: np.ndarray, t0: int, t1: int):
    """Span bookkeeping for one shard of a [n_terms, n_tiles+1] CSR grid.

    Returns (flat gather index into the flat payload, rebased local CSR
    of shape [n_terms, t1-t0+1], per-term span starts)."""
    starts = h_ptr[:, t0].astype(np.int64)
    ends = h_ptr[:, t1].astype(np.int64)
    lens = ends - starts
    total = int(lens.sum())
    out_starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=out_starts[1:])
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(out_starts[:-1], lens) + np.repeat(starts, lens))
    local = (h_ptr[:, t0:t1 + 1].astype(np.int64)
             - starts[:, None] + out_starts[:-1, None]).astype(np.int32)
    return flat, local, out_starts


def _pad_cols(a: np.ndarray, tps: int) -> np.ndarray:
    """Zero-pad a sliced [n_terms, real] metadata grid to tps columns."""
    if a.shape[1] == tps:
        return a
    out = np.zeros((a.shape[0], tps), dtype=a.dtype)
    out[:, :a.shape[1]] = a
    return out


def _pad_ptr(lp: np.ndarray, tps: int) -> np.ndarray:
    """Pad a rebased local CSR to tps+1 cols, repeating the last offset."""
    n_terms, cols = lp.shape
    out = np.empty((n_terms, tps + 1), dtype=np.int32)
    out[:, :cols] = lp
    out[:, cols:] = lp[:, -1:]
    return out


def _pad_flat(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=a.dtype)
    out[:len(a)] = a
    return out


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def shard_index(index, n_shards: int, device="cuda") -> ShardedImpactIndex:
    """Partition ``index`` (fp32 or compressed) into ``n_shards``
    contiguous tile ranges, stacked on ``device``.

    A host-side numpy repack (the index is read to the host once); shards
    are padded to a common static shape so the result stacks on a leading
    shard axis. The leaves keep the source index's device dtypes.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    kind = index.gather_kind
    if kind == "fp32":
        names = _FP32_LEAVES
    elif kind == "q8":
        names = _Q8_LEAVES
    else:
        raise ValueError(f"unknown gather kind: {kind!r}")
    n_terms, n_tiles = index.n_terms, index.n_tiles
    tile_size = index.tile_size
    tps = -(-n_tiles // n_shards)  # ceil: padded tiles per shard

    h = {n: _host(getattr(index, n)) for n in names}
    h_tmb = _host(index.tile_max_b)
    h_tml = _host(index.tile_max_l)
    h_ptr = h["tile_ptr"]

    shard_gather = []   # per-shard gather tuples (numpy)
    tmb_l, tml_l, base_l = [], [], []
    nnz = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        t0 = min(s * tps, n_tiles)
        t1 = min((s + 1) * tps, n_tiles)
        flat, lp_real, _ = _csr_shard_gather(h_ptr, t0, t1)
        lp = _pad_ptr(lp_real, tps)
        nnz[s] = len(flat)
        if kind == "fp32":
            local_doc = (h["docids"][flat].astype(np.int64)
                         - t0 * tile_size).astype(np.int32)
            shard_gather.append((local_doc, h["w_b"][flat], h["w_l"][flat],
                                 lp))
        else:
            wflat, lpw_real, _ = _csr_shard_gather(h["pack_ptr"], t0, t1)
            lpw = _pad_ptr(lpw_real, tps)
            shard_gather.append((
                h["packed"][wflat], h["qb"][flat], h["ql"][flat], lp, lpw,
                *(_pad_cols(h[g][:, t0:t1], tps) for g in _Q8_LEAVES[5:])))
        tmb = np.zeros((n_terms, tps), dtype=np.float32)
        tml = np.zeros((n_terms, tps), dtype=np.float32)
        tmb[:, :t1 - t0] = h_tmb[:, t0:t1]
        tml[:, :t1 - t0] = h_tml[:, t0:t1]
        tmb_l.append(tmb)
        tml_l.append(tml)
        base_l.append(t0 * tile_size)

    # pad every shard's flat leaves (postings, and words for q8) to the
    # max length, then stack each gather slot on the shard axis
    gather = []
    for i in range(len(names)):
        leaves = [sg[i] for sg in shard_gather]
        if i in _FLAT_SLOTS:
            m = max(1, max(len(a) for a in leaves))
            leaves = [_pad_flat(a, m) for a in leaves]
        gather.append(torch.from_numpy(np.stack(leaves)).to(dev))

    n_real = np.clip(n_tiles - tps * np.arange(n_shards), 0, tps
                     ).astype(np.int32)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ShardedImpactIndex(
        n_shards=n_shards, n_docs=index.n_docs, n_terms=n_terms,
        tile_size=tile_size, n_tiles=n_tiles, tiles_per_shard=tps,
        pad_len=index.pad_len,
        doc_base=on_dev(np.array(base_l, dtype=np.int32)),
        n_real_tiles=on_dev(n_real), nnz_per_shard=nnz,
        gather=tuple(gather), gather_kind=kind,
        tile_max_b=on_dev(np.stack(tmb_l)),
        tile_max_l=on_dev(np.stack(tml_l)),
        sigma_b=index.sigma_b.to(dev), sigma_l=index.sigma_l.to(dev),
        orig_of_new=index.orig_of_new)
