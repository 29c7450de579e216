"""CompressedImpactIndex: the BII layout with compressed posting storage.

Same tile geometry and planner metadata as ``core.index.BlockedImpactIndex``
(identical ``tile_ptr``, *exact* fp32 per-(term, tile) maxima and list
maxima, same padded-gather contract), but the flat posting arrays are
stored compressed:

  docids   ->  per-run first offset + delta-1 gaps bit-packed at a per-run
               width from {1, 2, 4, 8, 16} into 32-bit words (``pack_ptr``
               is the word-granular CSR mirror of ``tile_ptr``; every run
               is word-aligned),
  impacts  ->  uint8 codes with per-run fp16 scale/zero-point, rounded so
               dequantized values never exceed the exact fp32 tile max
               (``codec.quantize_runs``), so chunk scheduling and theta
               pruning plan exactly as on the fp32 index.

Types on the device: ``packed`` int32 (a bitcast of the uint32 words;
torch's uint32 support is partial), ``qb``/``ql`` and ``width`` uint8,
``first`` int32 (uint16 in the npz), ``scale_*``/``zero_*`` float16 (their
cast to float32 is exact), ``tile_ptr``/``pack_ptr`` int32, maxima float32.
``save``/``load`` use the JAX package's npz format, in both directions.

Two gathers read it: ``gather_tile_q`` decodes into the fp32 gather's
``(offs, wb, wl)`` contract (the plain path), ``gather_tile_q_raw`` fetches
undecoded rows for the decode-in-kernel scorers
(``kernels.guided_score.guided_score_tile_q`` / ``guided_score_chunk_q``).
Both are batched: ``q_terms`` [..., Nq] and ``tile`` [...] share their
leading dims, as in ``core.index.gather_tile``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.align import MergedPostings
from ..core.index import blocked_layout, resolve_device
from ..kernels.guided_score import decode_rows
from . import codec

# Tensor fields in the reference's order: the posting payload that
# ``gather_arrays`` returns, then the exact bounds.
GATHER_FIELDS = ("packed", "qb", "ql", "tile_ptr", "pack_ptr", "width",
                 "first", "scale_b", "zero_b", "scale_l", "zero_l")
TENSOR_FIELDS = GATHER_FIELDS + ("tile_max_b", "tile_max_l", "sigma_b",
                                 "sigma_l")
SCALAR_FIELDS = ("n_docs", "n_terms", "tile_size", "n_tiles", "pad_len",
                 "nnz")
# host dtype of each field in the npz (the reference's), and on the device
_NPZ_DTYPES = dict(packed=np.uint32, qb=np.uint8, ql=np.uint8,
                   tile_ptr=np.int32, pack_ptr=np.int32, width=np.uint8,
                   first=np.uint16, scale_b=np.float16, zero_b=np.float16,
                   scale_l=np.float16, zero_l=np.float16,
                   tile_max_b=np.float32, tile_max_l=np.float32,
                   sigma_b=np.float32, sigma_l=np.float32)


def _to_device(name: str, arr, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr, dtype=_NPZ_DTYPES[name])
    if name == "packed":
        arr = arr.view(np.int32)
    elif name == "first":
        arr = arr.astype(np.int32)
    if not arr.flags.writeable:   # torch does not wrap read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def _to_host(name: str, t: torch.Tensor) -> np.ndarray:
    arr = t.cpu().numpy()
    if name == "packed":
        return arr.view(np.uint32)
    return arr.astype(_NPZ_DTYPES[name], copy=False)


@dataclasses.dataclass
class CompressedImpactIndex:
    n_docs: int
    n_terms: int
    tile_size: int
    n_tiles: int
    pad_len: int
    nnz: int
    # compressed flat postings (term-major, docid-sorted within term)
    packed: torch.Tensor    # [n_words] int32 bitcast of the packed words
    qb: torch.Tensor        # [nnz] uint8 quantized BM25 impacts
    ql: torch.Tensor        # [nnz] uint8 quantized learned impacts
    # per-(term, tile) structure
    tile_ptr: torch.Tensor  # [n_terms, n_tiles + 1] int32 posting offsets
    pack_ptr: torch.Tensor  # [n_terms, n_tiles + 1] int32 word offsets
    width: torch.Tensor     # [n_terms, n_tiles] uint8 gap bit width
    first: torch.Tensor     # [n_terms, n_tiles] int32 first local offset
    scale_b: torch.Tensor   # [n_terms, n_tiles] f16
    zero_b: torch.Tensor    # [n_terms, n_tiles] f16
    scale_l: torch.Tensor   # [n_terms, n_tiles] f16
    zero_l: torch.Tensor    # [n_terms, n_tiles] f16
    # exact fp32 bounds, unchanged from the uncompressed index
    tile_max_b: torch.Tensor
    tile_max_l: torch.Tensor
    sigma_b: torch.Tensor
    sigma_l: torch.Tensor
    orig_of_new: np.ndarray | None = None

    gather_kind = "q8"

    @property
    def device(self) -> torch.device:
        return self.tile_ptr.device

    def gather_arrays(self) -> tuple[torch.Tensor, ...]:
        """Posting-side payload for ``core.index.dispatch_gather`` and
        ``gather_tile_q_raw``."""
        return tuple(getattr(self, f) for f in GATHER_FIELDS)

    def to(self, device) -> "CompressedImpactIndex":
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

    def nbytes(self) -> dict:
        """Bytes each component holds on its device (+ ``total``)."""
        comp = {f: getattr(self, f).numel() * getattr(self, f).element_size()
                for f in TENSOR_FIELDS}
        comp["total"] = sum(comp.values())
        return comp

    def fp32_nbytes(self) -> int:
        """Bytes of the fp32 ``BlockedImpactIndex`` holding the same
        postings and geometry (docids + w_b + w_l, tile_ptr, tile maxima,
        sigmas): the baseline of the compression ratio."""
        return (self.nnz * 12
                + self.n_terms * (self.n_tiles + 1) * 4
                + self.n_terms * self.n_tiles * 8
                + self.n_terms * 8)

    def save(self, path) -> None:
        """Persist to one ``.npz`` in the JAX package's format."""
        meta = np.array([getattr(self, f) for f in SCALAR_FIELDS], np.int64)
        arrays = {f: _to_host(f, getattr(self, f)) for f in TENSOR_FIELDS}
        if self.orig_of_new is not None:
            arrays["orig_of_new"] = self.orig_of_new
        np.savez(path, meta=meta, **arrays)

    @classmethod
    def load(cls, path, device="cuda") -> "CompressedImpactIndex":
        """Read an npz written by ``save`` (here or in the JAX package)."""
        with np.load(path) as z:
            fields = {f: z[f] for f in TENSOR_FIELDS}
            fields.update(zip(SCALAR_FIELDS, z["meta"].tolist()))
            fields["orig_of_new"] = (z["orig_of_new"]
                                     if "orig_of_new" in z.files else None)
        return index_from_fields(fields, device)


def index_from_fields(fields: dict, device="cuda") -> CompressedImpactIndex:
    """A ``CompressedImpactIndex`` on ``device`` from host fields: numpy
    arrays in the npz dtypes (or any dtype holding the same values) and
    ints, as the JAX package's index carries them."""
    dev = resolve_device(device)
    missing = [f for f in SCALAR_FIELDS + TENSOR_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"compressed index fields missing: {missing}")
    orig = fields.get("orig_of_new")
    return CompressedImpactIndex(
        **{f: int(np.asarray(fields[f])) for f in SCALAR_FIELDS},
        **{f: _to_device(f, fields[f], dev) for f in TENSOR_FIELDS},
        orig_of_new=None if orig is None else np.asarray(orig, np.int32))


def encode_runs(loc: np.ndarray, w_b: np.ndarray, w_l: np.ndarray,
                run_of: np.ndarray, cnt_flat: np.ndarray) -> dict:
    """Encode term-major postings grouped into (term, tile) runs.

    loc:      [nnz] tile-local offsets, strictly increasing within a run
    run_of:   [nnz] run id per posting (non-decreasing)
    cnt_flat: [n_runs] postings per run

    Returns numpy arrays: ``packed`` (uint32, runs word-aligned in run-id
    order), ``qb``/``ql`` (uint8, posting order), and per-run ``width``
    (uint8), ``first`` (uint16), ``words`` (int64), scale/zero fp16 pairs.
    Runs are self-contained, so concatenating the outputs of per-chunk
    encodes (in global run order) equals one encode of the whole corpus.
    """
    loc = np.asarray(loc, dtype=np.int64)
    run_of = np.asarray(run_of, dtype=np.int64)
    cnt_flat = np.asarray(cnt_flat, dtype=np.int64)
    n_runs = len(cnt_flat)
    nnz = len(loc)
    run_start = np.zeros(n_runs + 1, dtype=np.int64)
    np.cumsum(cnt_flat, out=run_start[1:])
    if int(run_start[-1]) != nnz:
        raise ValueError("cnt_flat does not sum to len(loc)")

    pos = np.arange(nnz, dtype=np.int64) - run_start[run_of]
    is_first = pos == 0
    prev = np.empty(nnz, dtype=np.int64)
    prev[1:] = loc[:-1]
    prev[:1] = 0
    gaps = np.where(is_first, 0, loc - prev - 1)
    if nnz and int(gaps.min()) < 0:
        raise ValueError("run offsets must be strictly increasing")

    enc_mask = ~is_first
    maxv = np.zeros(n_runs, dtype=np.int64)
    np.maximum.at(maxv, run_of[enc_mask], gaps[enc_mask])
    width = codec.choose_width(maxv)
    words = codec.words_for(np.maximum(cnt_flat - 1, 0), width)
    word_start = np.zeros(n_runs + 1, dtype=np.int64)
    np.cumsum(words, out=word_start[1:])
    packed = codec.pack_runs(gaps[enc_mask], run_of[enc_mask],
                             (pos - 1)[enc_mask], width, word_start[:-1])
    total_words = int(word_start[-1])
    if len(packed) < total_words:  # trailing empty runs
        packed = np.concatenate(
            [packed, np.zeros(total_words - len(packed), np.uint32)])

    first = np.zeros(n_runs, dtype=np.int64)
    first[run_of[is_first]] = loc[is_first]
    if n_runs and int(first.max(initial=0)) > 0xFFFF:
        raise ValueError("tile-local offset exceeds uint16; "
                         "tile_size must be <= 65536")

    qb, scale_b, zero_b = codec.quantize_runs(w_b, run_of, n_runs)
    ql, scale_l, zero_l = codec.quantize_runs(w_l, run_of, n_runs)
    return dict(packed=packed, qb=qb, ql=ql, width=width,
                first=first.astype(np.uint16), words=words,
                scale_b=scale_b, zero_b=zero_b,
                scale_l=scale_l, zero_l=zero_l)


def _grid_ptr(cnt: np.ndarray) -> np.ndarray:
    """[n_terms, n_tiles + 1] int32 CSR pointers from per-run counts laid
    out term-major: row t holds the global offsets of its runs and, last,
    the end of its final run."""
    n_terms, n_tiles = cnt.shape
    flat = np.zeros(n_terms * n_tiles + 1, dtype=np.int64)
    np.cumsum(cnt.reshape(-1), out=flat[1:])
    ptr = np.empty((n_terms, n_tiles + 1), dtype=np.int32)
    ptr[:, :-1] = flat[:-1].reshape(n_terms, n_tiles)
    ptr[:, -1] = flat[1:].reshape(n_terms, n_tiles)[:, -1]
    return ptr


def from_encoded_grids(n_docs: int, n_terms: int, tile_size: int,
                       cnt: np.ndarray, words: np.ndarray,
                       packed: np.ndarray, qb: np.ndarray, ql: np.ndarray,
                       width: np.ndarray, first: np.ndarray,
                       scale_b: np.ndarray, zero_b: np.ndarray,
                       scale_l: np.ndarray, zero_l: np.ndarray,
                       tile_max_b: np.ndarray, tile_max_l: np.ndarray,
                       *, pad_multiple: int = 8, pad_cap: int | None = None,
                       orig_of_new: np.ndarray | None = None,
                       device="cuda") -> CompressedImpactIndex:
    """Assemble the index on ``device`` from [n_terms, n_tiles] metadata
    grids plus the flat encoded arrays (global term-major run order)."""
    n_tiles = cnt.shape[1]
    run_max = int(cnt.max()) if cnt.size else 0
    pad_len = max(pad_multiple, -(-run_max // pad_multiple) * pad_multiple)
    if pad_cap is not None:
        pad_len = min(pad_len, pad_cap)
        if run_max > pad_len:
            raise ValueError(f"pad_cap {pad_cap} < max run {run_max}")
    grid = (n_terms, n_tiles)
    return index_from_fields(dict(
        n_docs=n_docs, n_terms=n_terms, tile_size=tile_size,
        n_tiles=n_tiles, pad_len=pad_len, nnz=int(cnt.sum()),
        packed=packed, qb=qb, ql=ql, tile_ptr=_grid_ptr(cnt),
        pack_ptr=_grid_ptr(np.asarray(words)),
        width=np.reshape(width, grid), first=np.reshape(first, grid),
        scale_b=np.reshape(scale_b, grid), zero_b=np.reshape(zero_b, grid),
        scale_l=np.reshape(scale_l, grid), zero_l=np.reshape(zero_l, grid),
        tile_max_b=tile_max_b, tile_max_l=tile_max_l,
        sigma_b=tile_max_b.max(axis=1), sigma_l=tile_max_l.max(axis=1),
        orig_of_new=orig_of_new), device)


def compress_index(merged: MergedPostings, tile_size: int = 2048,
                   pad_multiple: int = 8, pad_cap: int | None = None,
                   doc_order: np.ndarray | None = None,
                   device="cuda") -> CompressedImpactIndex:
    """One-shot compressed build onto ``device``: the same signature and
    tile layout as ``core.build_index`` (via ``blocked_layout``), with the
    flat postings encoded instead of stored fp32."""
    resolve_device(device)   # fail before the host build, not after
    lay = blocked_layout(merged, tile_size, pad_multiple, pad_cap, doc_order)
    n_terms, n_tiles = lay["n_terms"], lay["n_tiles"]
    docids = lay["docids"].astype(np.int64)
    tile_of = docids // tile_size
    term_of = np.repeat(np.arange(n_terms, dtype=np.int64),
                        lay["cnt"].sum(axis=1, dtype=np.int64))
    run_of = term_of * n_tiles + tile_of
    loc = docids - tile_of * tile_size
    enc = encode_runs(loc, lay["w_b"], lay["w_l"], run_of,
                      lay["cnt"].reshape(-1))
    return from_encoded_grids(
        lay["n_docs"], n_terms, tile_size, lay["cnt"],
        enc["words"].reshape(n_terms, n_tiles), enc["packed"], enc["qb"],
        enc["ql"], enc["width"], enc["first"], enc["scale_b"],
        enc["zero_b"], enc["scale_l"], enc["zero_l"], lay["tile_max_b"],
        lay["tile_max_l"], pad_multiple=pad_multiple, pad_cap=pad_cap,
        orig_of_new=lay["orig_of_new"], device=device)


# ---------------------------------------------------------------------------
# Query-time gathers
# ---------------------------------------------------------------------------

def raw_words_len(pad_len: int) -> int:
    """Packed words that cover a run of ``pad_len`` postings: at most
    ``pad_len - 1`` gaps at 16 bits = ceil((pad_len - 1) / 2) words."""
    return max(1, (pad_len + 1) // 2)


def _take_clip(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with indices past the end clamped to the last element,
    as the reference's ``jnp.take(..., mode="clip")`` reads them."""
    if a.numel() == 0:
        return torch.zeros(idx.shape, dtype=a.dtype, device=a.device)
    return a[idx.clamp(max=a.numel() - 1)]


def gather_tile_q_raw(gt: tuple, q_terms: torch.Tensor, tile: torch.Tensor,
                      *, pad_len: int):
    """Fetch *undecoded* per-term rows for the decode-in-kernel scorers.

    ``q_terms`` [..., Nq], ``tile`` [...]. Returns:
      words   [..., Nq, Wp] int32: the run's packed gap words (Wp =
              ``raw_words_len(pad_len)``; past the run: the next words,
              clamped at the end of ``packed``)
      qb_row  [..., Nq, P]  uint8: raw impact codes (past ``cnt``: the
      ql_row                       next postings', clamped at the end)
      meta_i  [..., 3, Nq]  int32: rows cnt, first, width
      meta_f  [..., 4, Nq]  f32:   rows zero_b, scale_b, zero_l, scale_l
    Tile ids past the last tile (the chunk schedule's sentinel) are
    clamped: their ``cnt`` is 0 and the other metadata is the last tile's,
    as the reference's clipped gathers read them.
    """
    (packed, qb, ql, tile_ptr, pack_ptr, width, first,
     scale_b, zero_b, scale_l, zero_l) = gt
    n_tiles = tile_ptr.shape[1] - 1
    qt = q_terms.long()
    t = tile.long()[..., None]
    t_ptr = t.clamp(0, n_tiles)            # [n_terms, n_tiles + 1] grids
    t_run = t.clamp(0, n_tiles - 1)        # [n_terms, n_tiles] grids
    start = tile_ptr[qt, t_ptr]                                    # [..., Nq]
    cnt = tile_ptr[qt, (t + 1).clamp(0, n_tiles)] - start
    dev = tile_ptr.device
    wp = raw_words_len(pad_len)
    words = _take_clip(packed, pack_ptr[qt, t_ptr].long()[..., None]
                       + torch.arange(wp, device=dev))
    idx = start.long()[..., None] + torch.arange(pad_len, device=dev)
    meta_i = torch.stack([cnt, first[qt, t_run].int(),
                          width[qt, t_run].int()], -2)
    meta_f = torch.stack([a[qt, t_run].float()
                          for a in (zero_b, scale_b, zero_l, scale_l)], -2)
    return words, _take_clip(qb, idx), _take_clip(ql, idx), meta_i, meta_f


def gather_tile_q(gt: tuple, q_terms: torch.Tensor, tile: torch.Tensor,
                  qw_b: torch.Tensor | None = None,
                  qw_l: torch.Tensor | None = None, *, pad_len: int):
    """Decode-on-gather: the q8 counterpart of ``core.index.gather_tile``.

    Returns the same (offs [..., Nq, P] int32, -1 = padding; wb, wl
    [..., Nq, P] f32, 0 = padding) contract: gap j decodes as one word
    load, shift and mask (widths divide 32, so no value spans two words),
    offsets are ``first`` plus a cumsum of the gaps + 1, and impacts
    dequantize as ``zero + scale * q`` (each <= the exact fp32 tile max by
    construction), then scale by the query weight as the fp32 gather does.
    This is the raw gather followed by the decode the kernels' plain
    versions run (``kernels.guided_score.decode_rows``).
    """
    return decode_rows(*gather_tile_q_raw(gt, q_terms, tile,
                                          pad_len=pad_len), qw_b, qw_l)
