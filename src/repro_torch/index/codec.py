"""Compression primitives for the blocked impact index.

Two codecs, both operating on per-(term, tile) posting runs — the unit
the padded gather fetches, so decode never crosses a run boundary:

- **delta + bit-pack** for tile-local doc offsets. Within a run offsets
  are strictly increasing, so gaps are positive; we store ``gap - 1`` at
  a per-run fixed width drawn from {1, 2, 4, 8, 16} bits. Every width
  divides 32, so a packed value never spans a uint32 word boundary —
  the decode is one word load, one shift, one mask, with no two-word
  stitching (the property the in-kernel CUDA decoder relies on). The
  run's *first* offset is stored separately in the run metadata
  (uint16), so a single far-into-the-tile posting never widens the run.
- **int8 linear quantization** for the two impact channels, with per-run
  fp16 scale/zero-point. Both are rounded *toward -inf* so that
  ``fl(zero + scale * q) <= max(run)`` holds in exact float32 arithmetic
  for every q <= 255 (scale*q has <= 19 mantissa bits, hence exact; the
  final add rounds monotonically below the representable run max). The
  exact fp32 tile maxima therefore remain true upper bounds for the
  dequantized impacts — chunk scheduling and theta pruning are unchanged
  from the uncompressed index.

Encoders are host-side numpy (vectorized over all runs at once, no
per-run Python loop); the numpy decoders here are the reference the
round-trip tests pin, while the query-path torch decoder lives in
``repro_torch.index.compressed.gather_tile_q`` and the in-kernel one in
``repro_torch/kernels/csrc/guided_score_tile.cu``. A numpy copy of the JAX
package's ``repro/index/codec.py``: its outputs are byte-equal to it,
including the fp16 scale that goes subnormal for run maxima below about
1e-2.
"""
from __future__ import annotations

import numpy as np

# Allowed per-run bit widths. Each divides 32, so packed values are
# always contained in a single uint32 word.
WIDTHS = (1, 2, 4, 8, 16)

# max encodable value (gap - 1) -> width: _WIDTH_OF[bit_length(maxval)]
_WIDTH_OF = np.array([1, 1, 2, 4, 4, 8, 8, 8, 8, 16, 16, 16, 16, 16, 16, 16,
                      16], dtype=np.uint8)

VALS_PER_WORD = {w: 32 // w for w in WIDTHS}


def choose_width(max_val) -> np.ndarray:
    """Smallest allowed width holding ``max_val`` (vectorized, uint8).

    ``max_val`` is the largest encoded value of a run (``max gap - 1``);
    values above 2**16 - 1 are rejected — a tile never spans more than
    65536 docids in this index (``tile_size`` cap in the builder).
    """
    mv = np.asarray(max_val)
    if mv.size and int(mv.max(initial=0)) > 0xFFFF:
        raise ValueError(f"encoded value {int(mv.max())} exceeds 16 bits; "
                         f"tile_size must be <= 65536")
    # bit_length via log2 on max(val, 1): bl(v) = floor(log2(v)) + 1
    bl = np.zeros(mv.shape, dtype=np.int64)
    pos = mv > 0
    bl[pos] = np.floor(np.log2(mv[pos].astype(np.float64))).astype(np.int64) + 1
    return _WIDTH_OF[bl]


def words_for(count, width) -> np.ndarray:
    """uint32 words needed for ``count`` values at ``width`` bits each."""
    count = np.asarray(count, dtype=np.int64)
    width = np.asarray(width, dtype=np.int64)
    return -(-(count * width) // 32)


def pack_runs(values: np.ndarray, run_of: np.ndarray, val_idx: np.ndarray,
              width_of_run: np.ndarray, word_start: np.ndarray) -> np.ndarray:
    """Bit-pack per-run values into one flat uint32 array.

    values:        [n] encoded values (< 2**width of their run)
    run_of:        [n] run index of each value
    val_idx:       [n] position of the value within its run (0-based)
    width_of_run:  [n_runs] per-run width (from ``choose_width``)
    word_start:    [n_runs] first word of each run (``words_for`` cumsum)

    Every run starts on a fresh word (word-aligned), which is what lets
    runs be sliced/concatenated — by the sharder and the streaming
    builder — without re-packing. Returns the packed word array sized
    ``word_start[-1] + words_for(last run)``; one ``bitwise_or.at``
    scatter, no Python loop.
    """
    w = width_of_run[run_of].astype(np.int64)
    bitpos = val_idx.astype(np.int64) * w
    word_idx = word_start[run_of].astype(np.int64) + (bitpos >> 5)
    shift = (bitpos & 31).astype(np.uint32)
    n_words = int(word_idx.max()) + 1 if len(word_idx) else 0
    packed = np.zeros(n_words, dtype=np.uint32)
    np.bitwise_or.at(packed, word_idx,
                     np.left_shift(values.astype(np.uint32), shift))
    return packed


def unpack_run(packed: np.ndarray, word_start: int, width: int,
               count: int) -> np.ndarray:
    """Reference numpy decoder for one run: ``count`` values at ``width``
    bits starting at word ``word_start``. Mirrors the torch/CUDA decode
    arithmetic exactly (word load, shift, mask)."""
    j = np.arange(count, dtype=np.int64)
    bitpos = j * width
    word = packed[word_start + (bitpos >> 5)]
    mask = np.uint32((1 << width) - 1)
    return ((word >> (bitpos & 31).astype(np.uint32)) & mask).astype(np.int64)


def delta_encode(offsets: np.ndarray) -> tuple[int, np.ndarray]:
    """One run's strictly-increasing tile-local offsets -> (first, gaps-1)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    if len(offsets) == 0:
        return 0, np.zeros(0, dtype=np.int64)
    d = np.diff(offsets)
    if len(d) and d.min() <= 0:
        raise ValueError("run offsets must be strictly increasing")
    return int(offsets[0]), d - 1


def delta_decode(first: int, vals: np.ndarray) -> np.ndarray:
    """Inverse of ``delta_encode``: offs[0]=first, offs[j]=offs[j-1]+v+1."""
    vals = np.asarray(vals, dtype=np.int64)
    out = np.empty(len(vals) + 1, dtype=np.int64)
    out[0] = first
    np.cumsum(vals + 1, out=out[1:])
    out[1:] += first
    return out


def fp16_down(x: np.ndarray) -> np.ndarray:
    """Largest float16 <= x, for x >= 0 (elementwise).

    numpy's float16 cast rounds to nearest; when that rounds *up* we step
    the uint16 bit pattern down one ulp (positive float16 ordering equals
    uint16 ordering, so this also collapses +inf overflow to 65504).
    """
    x = np.asarray(x, dtype=np.float32)
    h = x.astype(np.float16)
    stepped = (h.view(np.uint16) - np.uint16(1)).view(np.float16)
    return np.where(h.astype(np.float32) > x, stepped, h)


def quantize_runs(w: np.ndarray, run_of: np.ndarray, n_runs: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """int8-quantize impact values grouped by run.

    Returns (q uint8 [n], scale fp16 [n_runs], zero fp16 [n_runs]) with
    the bound-safety guarantee ``fl(zero + scale * q) <= max(run)`` in
    float32 for all q <= 255:

    - ``zero``  = fp16 round-down of the run min  (zero <= min),
    - ``scale`` = fp16 round-down of (max - zero) / 255, so
      ``scale * 255 <= max - zero`` exactly; ``scale * q`` has <= 19
      mantissa bits (11-bit fp16 significand x 8-bit q) hence is exact in
      fp32, and the final add rounds monotonically to <= the
      representable run max.

    Empty runs get scale = zero = 0.
    """
    w = np.asarray(w, dtype=np.float32)
    run_of = np.asarray(run_of, dtype=np.int64)
    mx = np.full(n_runs, -np.inf, dtype=np.float32)
    mn = np.full(n_runs, np.inf, dtype=np.float32)
    np.maximum.at(mx, run_of, w)
    np.minimum.at(mn, run_of, w)
    empty = ~np.isfinite(mx)
    mx[empty] = 0.0
    mn[empty] = 0.0
    zero = fp16_down(mn)
    span = (mx - zero.astype(np.float32)) / 255.0
    scale = fp16_down(np.maximum(span, 0.0))
    s32 = scale.astype(np.float32)
    z32 = zero.astype(np.float32)
    denom = np.where(s32[run_of] > 0, s32[run_of], 1.0)
    q = np.rint((w - z32[run_of]) / denom)
    q = np.clip(np.where(s32[run_of] > 0, q, 0.0), 0, 255).astype(np.uint8)
    return q, scale.astype(np.float16), zero.astype(np.float16)


def dequantize(q: np.ndarray, scale, zero) -> np.ndarray:
    """Reference dequant: the exact float32 expression the gather uses."""
    return (np.asarray(zero, np.float32)
            + np.asarray(scale, np.float32) * np.asarray(q, np.float32))
