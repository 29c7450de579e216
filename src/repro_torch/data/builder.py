"""StreamingIndexBuilder: a compressed index built one corpus chunk at a
time, with checkpointed resume.

Chunks (``CorpusChunk``: contiguous docid ranges) are encoded one by one
with the one-shot compressor's per-run codec (``index.encode_runs``). Runs
are word-aligned and self-contained, so the per-chunk outputs concatenate
into the global index bit for bit equal to ``compress_index`` over the
whole corpus.

Durability: each completed chunk is spilled to its own ``.npz`` (written
under a temporary name, then ``os.replace``d), and only then recorded in
``manifest.json`` (written, fsync'd and replaced the same way). A crash
between the two leaves an orphan spill that resume simply writes again; a
crash mid-spill leaves a temporary file the manifest never names.
``add_chunk`` skips a chunk already recorded, so resume is "reopen the
builder, replay the stream".

The directory format (manifest keys, npz names and dtypes) is the JAX
package's: a directory either package wrote finalizes in the other.
``finalize`` reorders the per-chunk flat arrays into global term-major run
order with one gather and puts the index on ``device`` through
``index.from_encoded_grids``.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..core.index import resolve_device
from ..index.compressed import encode_runs, from_encoded_grids
from .corpus import CorpusChunk

_GRID_KEYS = ("cnt", "words", "width", "first", "scale_b", "zero_b",
              "scale_l", "zero_l", "tile_max_b", "tile_max_l")
_FLAT_KEYS = ("packed", "qb", "ql")


class StreamingIndexBuilder:
    """Build a ``CompressedImpactIndex`` from corpus chunks with
    checkpoint and resume.

    ``chunk_docs`` must be a multiple of ``tile_size`` so that every chunk
    owns whole tiles (the last chunk may be short). Opening an existing
    ``out_dir`` resumes: the chunks it records are kept and ``add_chunk``
    skips them.
    """

    def __init__(self, out_dir, *, n_terms: int, tile_size: int = 2048,
                 chunk_docs: int):
        if chunk_docs % tile_size != 0:
            raise ValueError(
                f"chunk_docs ({chunk_docs}) must be a multiple of "
                f"tile_size ({tile_size}) so chunks own whole tiles")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._manifest_path = self.out_dir / "manifest.json"
        if self._manifest_path.exists():
            with open(self._manifest_path) as f:
                m = json.load(f)
            for key, want in (("n_terms", n_terms),
                              ("tile_size", tile_size),
                              ("chunk_docs", chunk_docs)):
                if m[key] != want:
                    raise ValueError(
                        f"resume geometry mismatch in {self._manifest_path}:"
                        f" {key}={m[key]} on disk, {want} requested")
            self.manifest = m
        else:
            self.manifest = {"version": 1, "n_terms": n_terms,
                             "tile_size": tile_size, "chunk_docs": chunk_docs,
                             "chunks": {}}
            self._write_manifest()
        self.n_terms = n_terms
        self.tile_size = tile_size
        self.chunk_docs = chunk_docs

    # -- durability -----------------------------------------------------

    def _write_manifest(self) -> None:
        tmp = self._manifest_path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    def _chunk_path(self, chunk_id: int) -> Path:
        return self.out_dir / f"chunk_{chunk_id:05d}.npz"

    @property
    def completed_chunks(self) -> list[int]:
        return sorted(int(c) for c in self.manifest["chunks"])

    def has_chunk(self, chunk_id: int) -> bool:
        return str(chunk_id) in self.manifest["chunks"]

    # -- build ----------------------------------------------------------

    def add_chunk(self, chunk: CorpusChunk) -> bool:
        """Encode and spill one chunk, then record it in the manifest.

        Returns False (and does nothing) if the chunk is already recorded:
        the resume path.
        """
        if self.has_chunk(chunk.chunk_id):
            return False
        if chunk.doc_start != chunk.chunk_id * self.chunk_docs:
            raise ValueError(
                f"chunk {chunk.chunk_id} starts at doc {chunk.doc_start}, "
                f"expected {chunk.chunk_id * self.chunk_docs}")
        if chunk.n_docs > self.chunk_docs:
            raise ValueError(f"chunk {chunk.chunk_id} has {chunk.n_docs} "
                             f"docs > chunk_docs={self.chunk_docs}")
        t_c = -(-chunk.n_docs // self.tile_size)  # tiles in this chunk
        docids = np.asarray(chunk.docids, dtype=np.int64)
        terms = np.asarray(chunk.terms, dtype=np.int64)
        tile_of = docids // self.tile_size
        run_of = terms * t_c + tile_of
        cnt = np.bincount(run_of, minlength=self.n_terms * t_c
                          ).reshape(self.n_terms, t_c)
        loc = docids - tile_of * self.tile_size
        enc = encode_runs(loc, chunk.w_b, chunk.w_l, run_of, cnt.reshape(-1))

        tm_b = np.zeros((self.n_terms, t_c), dtype=np.float32)
        tm_l = np.zeros((self.n_terms, t_c), dtype=np.float32)
        np.maximum.at(tm_b.reshape(-1), run_of, chunk.w_b)
        np.maximum.at(tm_l.reshape(-1), run_of, chunk.w_l)

        def grid(a):
            return np.asarray(a).reshape(self.n_terms, t_c)
        path = self._chunk_path(chunk.chunk_id)
        tmp = path.with_name("tmp_" + path.name)  # savez wants a .npz name
        np.savez(tmp, packed=enc["packed"], qb=enc["qb"], ql=enc["ql"],
                 cnt=cnt, words=grid(enc["words"]), width=grid(enc["width"]),
                 first=grid(enc["first"]), scale_b=grid(enc["scale_b"]),
                 zero_b=grid(enc["zero_b"]), scale_l=grid(enc["scale_l"]),
                 zero_l=grid(enc["zero_l"]), tile_max_b=tm_b,
                 tile_max_l=tm_l)
        os.replace(tmp, path)
        self.manifest["chunks"][str(chunk.chunk_id)] = {
            "n_docs": int(chunk.n_docs), "file": path.name,
            "nnz": int(len(docids))}
        self._write_manifest()
        return True

    def finalize(self, *, pad_multiple: int = 8, pad_cap: int | None = None,
                 orig_of_new: np.ndarray | None = None, device="cuda"):
        """Concatenate all spilled chunks into the global index on
        ``device`` (asking for CUDA without a GPU raises, before any work).

        Per-chunk flat arrays are ordered (term, local tile); the global
        index needs (term, global tile) = (term, chunk, local tile). The
        reorder is one gather over per-(term, chunk) spans, each contiguous
        in its source because each chunk is term-major.
        """
        resolve_device(device)
        ids = self.completed_chunks
        if not ids:
            raise ValueError("no chunks to finalize")
        if ids != list(range(len(ids))):
            raise ValueError(f"chunk ids must be contiguous from 0, got {ids}")
        chunks = []
        n_docs = 0
        for cid in ids:
            rec = self.manifest["chunks"][str(cid)]
            if cid != ids[-1] and rec["n_docs"] != self.chunk_docs:
                raise ValueError(
                    f"non-final chunk {cid} has {rec['n_docs']} docs; only "
                    f"the last chunk may be short")
            with np.load(self.out_dir / rec["file"]) as z:
                chunks.append({k: z[k] for k in _GRID_KEYS + _FLAT_KEYS})
            n_docs += rec["n_docs"]

        grids = {k: np.concatenate([c[k] for c in chunks], axis=1)
                 for k in _GRID_KEYS}
        flat = {k: (np.concatenate([c[k] for c in chunks])
                    if len(chunks) > 1 else chunks[0][k])
                for k in _FLAT_KEYS}

        def reorder(a, counts_key):
            # source spans: term t's block inside chunk c (contiguous);
            # destination order: (t, c) row-major == global term-major
            per_tc = np.stack([c[counts_key].sum(axis=1, dtype=np.int64)
                               for c in chunks], axis=1)  # [n_terms, n_c]
            base = np.zeros(len(chunks), dtype=np.int64)
            np.cumsum([c[counts_key].sum(dtype=np.int64) for c in chunks
                       ][:-1], out=base[1:])
            # per chunk, the exclusive cumsum over terms: the source start
            # of term t's block within chunk c
            src0 = np.stack(
                [np.concatenate(([0], np.cumsum(
                    c[counts_key].sum(axis=1, dtype=np.int64))[:-1]))
                 for c in chunks], axis=1) + base[None, :]
            lens = per_tc.reshape(-1)
            src0 = src0.reshape(-1)
            total = int(lens.sum())
            dst0 = np.concatenate(([0], np.cumsum(lens)[:-1]))
            idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(dst0, lens) + np.repeat(src0, lens))
            return a[idx]

        qb = reorder(flat["qb"], "cnt")
        ql = reorder(flat["ql"], "cnt")
        packed = reorder(flat["packed"], "words")

        return from_encoded_grids(
            n_docs, self.n_terms, self.tile_size, grids["cnt"],
            grids["words"], packed, qb, ql, grids["width"], grids["first"],
            grids["scale_b"], grids["zero_b"], grids["scale_l"],
            grids["zero_l"], grids["tile_max_b"], grids["tile_max_l"],
            pad_multiple=pad_multiple, pad_cap=pad_cap,
            orig_of_new=orig_of_new, device=device)
