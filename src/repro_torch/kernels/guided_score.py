"""Guided tile scoring: the 2GTI hot loop as hand-written CUDA for Hopper.

Two kernels, each with a plain PyTorch version of the same contract:

  - ``guided_score_tile``  [B, Nq, P] -> [B, 5, S]: one tile per query.
    Replaces the TPU kernel ``repro/kernels/guided_score.py::
    guided_score_tile`` (body ``_kernel``), which the JAX package runs
    once per (query, tile) under ``vmap``.
  - ``guided_score_chunk`` [B, C, Nq, P] -> [B, C, 5, S]: a chunk of C
    tiles per query with a per-tile skip flag. Replaces ``repro/kernels/
    guided_score.py::guided_score_chunk`` (body ``_chunk_kernel``).

and their decode-in-kernel twins for the compressed (q8) index, which
take undecoded rows (``index.compressed.gather_tile_q_raw``), decode them
as ``decode_rows`` does and add a 6th output row, postings per slot:

  - ``guided_score_tile_q``  [B, Nq, ...] -> [B, 6, S]. Replaces
    ``guided_score_tile_q`` (body ``_kernel_q`` + ``_decode_rows``).
  - ``guided_score_chunk_q`` [B, C, Nq, ...] -> [B, C, 6, S]. Replaces
    ``guided_score_chunk_q`` (body ``_chunk_kernel_q`` + ``_decode_rows``).

Per (query, tile) both compute, over the tile's S doc slots:
  1. scatter each term's padded posting run (``offs``, -1 = padding) into
     dense rows; a slot survives when an essential term has a posting there;
  2. the descending freeze loop: before term i, a slot stays alive while
     ``essential[i]`` or ``beta*sb + (1-beta)*sl + prefix_beta[i] > th_lo``;
     surviving live slots accumulate both weights;
  3. rows Global/Local/Rank (alpha/beta/gamma combinations of the sums),
     the eval mask (survive & alive) and the rank mask (survive).
A skipped tile of a chunk publishes five (q8: six) zero rows.

Dispatch is by the tensors' device: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel (or raises). There is no fallback.

Inputs are as ``core.index.gather_tile`` produces them: each (row, term)
run is a strictly increasing sequence of distinct slots followed by -1
padding. The kernel relies on both (each (term, slot) gets at most one
posting; a run ends at its first -1).

Bound on an H100 SXM (3.35 TB/s). The padded inputs are ``12*Nq*P``
bytes per live (query, tile) and the output ``20*S`` bytes; at Nq = 16,
P = S = 2048 that is about 0.43 MB, 0.13 us. A run is read only up to its
first padding entry, so the bytes the work needs are 12 per valid posting
plus the output; ``chip_smoke.py`` computes that bound from each run's
data. The kernels store each posting straight into shared memory (one
posting per (term, slot); the TPU's one-hot matrix product is not
needed), keep the dense rows out of device memory, and write each output
element once.

All four run on one source, ``csrc/guided_score_tile.cu``: one kernel per
index, with a grid of (lane blocks, C tiles, B queries) and a tile as a
chunk of one tile with no skip flag. At the main path's sizes (about 7
postings per run) they are bound by latency: a warp per run with no block
barrier in the term loop, a presence bitmask per slot in place of zeroed
dense rows, the run scalars in shared memory. The lane block is
``tile_lane_width`` slots for one tile per query (128: 256 blocks at a
batch of 16 and S = 2048) and ``chunk_lane_width`` for a chunk (512 at
a [16, 8] chunk: 512 blocks, about two waves); a skipped tile reads its
flag, writes its zero rows and nothing else. The design and its reasons
are in the source's header.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

N_ROWS = 5          # Global, Local, Rank, eval mask, rank mask
N_ROWS_Q = 6        # the same, then postings per slot
# Doc slots per thread block (lane width) of the tile kernels: 2048 / 128 =
# 16 lane blocks per query, 256 blocks at a batch of 16 on the 132 SMs.
TILE_LANE_WIDTH = 128
# The widest lane block of a chunk, and the blocks of 512 threads the H100
# holds at once (132 SMs x 2: 64 registers a thread allow two per SM).
CHUNK_LANE_WIDTH = 512
RESIDENT_BLOCKS = 264
SMEM_OPTIN_BYTES = 232_448      # H100: the shared memory a block may opt in to


def tile_smem_bytes(nq: int, width: int, q8: bool) -> int:
    """Shared memory of one tile-kernel block (``guided_score_tile.cu``):
    dense weight rows ``[2, Nq, width]``, presence masks ``[ceil(Nq / 32),
    width]`` and the essential bitmask, then per term 2 scalars (fp32) or
    11 (q8), 4 bytes each."""
    nw = -(-nq // 32)
    return 4 * (2 * nq * width + nw * width + nw + (11 if q8 else 2) * nq)


def tile_lane_width(nq: int, tile_size: int) -> int:
    """Doc slots per block of the tile kernels: ``TILE_LANE_WIDTH``, halved
    (not below 32) while a q8 block of ``nq`` terms would not fit in
    ``SMEM_OPTIN_BYTES``, and no wider than the tile."""
    width = TILE_LANE_WIDTH
    while width > 32 and tile_smem_bytes(nq, width, True) > SMEM_OPTIN_BYTES:
        width //= 2
    return min(width, tile_size)


def chunk_lane_width(nq: int, tile_size: int, n_tiles: int) -> int:
    """Doc slots per block of the chunk kernels, for ``n_tiles`` (B * C)
    tiles: ``tile_lane_width``, doubled up to ``CHUNK_LANE_WIDTH`` while
    the grid keeps at least ``RESIDENT_BLOCKS`` blocks and a q8 block fits
    in ``SMEM_OPTIN_BYTES``, and no wider than the tile. Fewer, wider lane
    blocks cut the waves of a large chunk (at [16, 8] tiles of 2048 slots:
    512 blocks of 512 slots, about two waves, where 128 would give 2048,
    about eight); a small chunk keeps the tile kernels' width, which
    spreads its slots over more SMs."""
    width = tile_lane_width(nq, tile_size)
    while (width < min(CHUNK_LANE_WIDTH, tile_size)
           and n_tiles * -(-tile_size // (2 * width)) >= RESIDENT_BLOCKS
           and tile_smem_bytes(nq, 2 * width, True) <= SMEM_OPTIN_BYTES):
        width *= 2
    return min(width, tile_size)


def _scalar(x) -> float:
    """A coefficient rounded to float32, as a Python float: torch computes
    ``tensor * x`` and ``(1.0 - x) * tensor`` in float32 with it, as the
    kernels do with their float arguments."""
    return float(np.float32(float(x)))


# --------------------------------------------------------------------------
# Plain PyTorch versions (any device; the reference the kernels are held to)
# --------------------------------------------------------------------------

def _scatter_rows(offs, w, tile_size: int):
    """Dense per-term rows [..., Nq, S] from padded runs: each posting adds
    into its slot of an ``[..., Nq, S + 1]`` buffer whose last column
    absorbs the padding."""
    slot = torch.where(offs >= 0, offs, tile_size).long()
    dense = torch.zeros(offs.shape[:-1] + (tile_size + 1,),
                        dtype=torch.float32, device=offs.device)
    return dense.scatter_add_(-1, slot, w)[..., :tile_size]


def guided_score_tile_plain(offs, wb, wl, essential, prefix_beta, th_lo,
                            alpha, beta, gamma, *, tile_size: int):
    """Plain version of ``guided_score_tile``: leading dims ``[...]`` (one
    tile per row), ``offs``/``wb``/``wl`` [..., Nq, P], ``essential``/
    ``prefix_beta`` [..., Nq], ``th_lo`` [...] -> [..., 5, S] f32."""
    alpha, beta, gamma = (_scalar(c) for c in (alpha, beta, gamma))
    valid = (offs >= 0).float()
    dense_b = _scatter_rows(offs, wb * valid, tile_size)
    dense_l = _scatter_rows(offs, wl * valid, tile_size)
    cnt = _scatter_rows(offs, valid, tile_size)
    ess = essential.float() > 0
    survive = (cnt * ess[..., None]).sum(-2) > 0              # [..., S]

    nq = offs.shape[-2]
    sb = torch.zeros_like(survive, dtype=torch.float32)
    sl = torch.zeros_like(sb)
    alive = torch.ones_like(survive)
    for i in range(nq - 1, -1, -1):
        l_part = beta * sb + (1.0 - beta) * sl
        ok = ess[..., i, None] | (l_part + prefix_beta[..., i, None]
                                  > th_lo[..., None])
        alive = alive & ok
        gate = (survive & alive).float()
        sb = sb + gate * dense_b[..., i, :]
        sl = sl + gate * dense_l[..., i, :]
    return torch.stack([
        alpha * sb + (1.0 - alpha) * sl,
        beta * sb + (1.0 - beta) * sl,
        gamma * sb + (1.0 - gamma) * sl,
        (survive & alive).float(),
        survive.float(),
    ], dim=-2)


def guided_score_chunk_plain(offs, wb, wl, essential, prefix_beta, skip,
                             th_lo, alpha, beta, gamma, *, tile_size: int):
    """Plain version of ``guided_score_chunk``: ``offs``/``wb``/``wl``
    [B, C, Nq, P], ``essential``/``prefix_beta`` [B, C, Nq], ``skip``
    [B, C] (nonzero = skip), ``th_lo`` [B] -> [B, C, 5, S] f32; skipped
    tiles publish zeros."""
    th = th_lo[:, None].expand(skip.shape)
    out = guided_score_tile_plain(offs, wb, wl, essential, prefix_beta, th,
                                  alpha, beta, gamma, tile_size=tile_size)
    return torch.where((skip != 0)[..., None, None], 0.0, out)


def decode_rows(words, qb_row, ql_row, meta_i, meta_f, qw_b=None, qw_l=None):
    """Decode raw q8 rows into the fp32 gather's (offs, wb, wl) contract.

    ``words`` [..., Nq, Wp] int32 packed gap words, ``qb_row``/``ql_row``
    [..., Nq, P] uint8 codes, ``meta_i`` [..., 3, Nq] int32 (cnt, first,
    width), ``meta_f`` [..., 4, Nq] f32 (zero_b, scale_b, zero_l,
    scale_l), ``qw_b``/``qw_l`` [..., Nq] (omitted = unweighted). Posting j
    of a row is valid while ``j < cnt``; its gap is ``(word >> (bitpos &
    31)) & (2^w - 1)`` at ``bitpos = (j - 1) * w`` (the word index clamped
    to Wp - 1, as the TPU kernel clamps it); offsets are ``first`` plus
    the inclusive cumsum of ``gap + 1``; impacts dequantize as ``(zero +
    scale * q) * qw``, each product and sum rounded in float32 (``scale *
    q`` is exact). Padding gets offset -1 and weight 0.
    """
    p, wp = qb_row.shape[-1], words.shape[-1]
    cnt, first, width = (meta_i[..., r, :, None].long() for r in range(3))
    j = torch.arange(p, device=words.device)
    bitpos = (j - 1).clamp(min=0) * width                     # [..., Nq, P]
    word = torch.gather(words, -1, (bitpos >> 5).clamp(max=wp - 1))
    gap = ((word.long() & 0xFFFFFFFF) >> (bitpos & 31)) & ((1 << width) - 1)
    valid = j < cnt
    offs = torch.where(valid, torch.where(j == 0, first, gap + 1).cumsum(-1),
                       -1).to(torch.int32)

    def deq(codes, r, qw):
        zero, scale = meta_f[..., r, :, None], meta_f[..., r + 1, :, None]
        w = torch.where(valid, zero + scale * codes.float(), 0.0)
        return w if qw is None else w * qw[..., None]
    return offs, deq(qb_row, 0, qw_b), deq(ql_row, 2, qw_l)


def _with_slot_counts(out, offs, tile_size: int):
    """Rows [..., 5, S] plus the 6th: valid postings per slot."""
    cnt = _scatter_rows(offs, (offs >= 0).float(), tile_size).sum(-2)
    return torch.cat([out, cnt[..., None, :]], -2)


def guided_score_tile_q_plain(words, qb_row, ql_row, meta_i, meta_f, qw_b,
                              qw_l, essential, prefix_beta, th_lo, alpha,
                              beta, gamma, *, tile_size: int):
    """Plain version of ``guided_score_tile_q``: leading dims ``[...]`` (one
    tile per row), raw rows as ``decode_rows`` takes them, ``qw_b``/
    ``qw_l``/``essential``/``prefix_beta`` [..., Nq], ``th_lo`` [...] ->
    [..., 6, S] f32."""
    offs, wb, wl = decode_rows(words, qb_row, ql_row, meta_i, meta_f, qw_b,
                               qw_l)
    out = guided_score_tile_plain(offs, wb, wl, essential, prefix_beta,
                                  th_lo, alpha, beta, gamma,
                                  tile_size=tile_size)
    return _with_slot_counts(out, offs, tile_size)


def guided_score_chunk_q_plain(words, qb_row, ql_row, meta_i, meta_f, qw_b,
                               qw_l, essential, prefix_beta, skip, th_lo,
                               alpha, beta, gamma, *, tile_size: int):
    """Plain version of ``guided_score_chunk_q``: raw rows [B, C, ...],
    ``qw_b``/``qw_l`` [B, Nq] (one query's weights for all its tiles),
    ``essential``/``prefix_beta`` [B, C, Nq], ``skip`` [B, C] (nonzero =
    skip), ``th_lo`` [B] -> [B, C, 6, S] f32; skipped tiles publish
    zeros."""
    th = th_lo[:, None].expand(skip.shape)
    out = guided_score_tile_q_plain(words, qb_row, ql_row, meta_i, meta_f,
                                    qw_b[:, None], qw_l[:, None], essential,
                                    prefix_beta, th, alpha, beta, gamma,
                                    tile_size=tile_size)
    return torch.where((skip != 0)[..., None, None], 0.0, out)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(source: str, fn_name: str, inputs, coefs, out, sizes,
          block_s: int) -> torch.Tensor:
    """Launch ``fn_name`` of ``source``'s library on the current stream:
    the input pointers (None for an absent one), the float coefficients,
    the output pointer, the sizes, the doc slots per block and the stream.
    Raises when the launcher returns a CUDA error."""
    from . import build
    if out.numel() == 0:
        return out
    build.launch(source, fn_name, out.device,
                 *(ctypes.c_void_p(None) if t is None else t
                   for t in inputs), *coefs, out, *sizes, block_s)
    return out


def _launch(fn_name: str, offs, wb, wl, essential, prefix_beta, skip, th_lo,
            alpha, beta, gamma, *, b: int, c: int,
            tile_size: int) -> torch.Tensor:
    """Validate the inputs and launch one kernel on the current stream."""
    dev = offs.device
    nq, p = offs.shape[-2:]
    _check("offs", offs, torch.int32, (b, c, nq, p) if skip is not None
           else (b, nq, p), dev)
    for name, t in (("wb", wb), ("wl", wl)):
        _check(name, t, torch.float32, offs.shape, dev)
    for name, t in (("essential", essential), ("prefix_beta", prefix_beta)):
        _check(name, t, torch.float32, offs.shape[:-1], dev)
    _check("th_lo", th_lo, torch.float32, (b,), dev)
    if skip is not None:
        _check("skip", skip, torch.int32, (b, c), dev)
    if tile_size < 1:
        raise ValueError(f"tile_size={tile_size} must be >= 1")
    out = torch.empty(offs.shape[:-2] + (N_ROWS, tile_size),
                      dtype=torch.float32, device=dev)
    block_s = (chunk_lane_width(nq, tile_size, b * c) if skip is not None
               else tile_lane_width(nq, tile_size))
    return _call("guided_score_tile.cu", fn_name,
                 (offs, wb, wl, essential, prefix_beta, skip, th_lo),
                 (alpha, beta, gamma), out, (b, c, nq, p, tile_size),
                 block_s)


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"guided_score: unsupported device {t.device}")
    return t.device.type


def guided_score_tile(offs, wb, wl, essential, prefix_beta, th_lo,
                      alpha, beta, gamma, *, tile_size: int):
    """Score one tile per query: [B, Nq, P] inputs -> [B, 5, S].

    ``essential``/``prefix_beta`` [B, Nq] f32, ``th_lo`` [B] f32; ``alpha``,
    ``beta``, ``gamma`` shared scalars. CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in ``.launches``)."""
    if _device_of(offs) == "cpu":
        return guided_score_tile_plain(offs, wb, wl, essential, prefix_beta,
                                       th_lo, alpha, beta, gamma,
                                       tile_size=tile_size)
    out = _launch("guided_score_tile_launch", offs, wb, wl, essential,
                  prefix_beta, None, th_lo, _scalar(alpha), _scalar(beta),
                  _scalar(gamma), b=offs.shape[0], c=1, tile_size=tile_size)
    guided_score_tile.launches += 1
    return out


def guided_score_chunk(offs, wb, wl, essential, prefix_beta, skip, th_lo,
                       alpha, beta, gamma, *, tile_size: int):
    """Score a chunk of C tiles per query: [B, C, Nq, P] -> [B, C, 5, S].

    ``essential``/``prefix_beta`` [B, C, Nq] f32 (from the chunk-start
    thresholds), ``skip`` [B, C] int32 (nonzero = publish zeros), ``th_lo``
    [B] f32. CPU tensors run the plain version; CUDA tensors launch the
    kernel (counted in ``.launches``)."""
    if _device_of(offs) == "cpu":
        return guided_score_chunk_plain(offs, wb, wl, essential,
                                        prefix_beta, skip, th_lo, alpha,
                                        beta, gamma, tile_size=tile_size)
    out = _launch("guided_score_chunk_launch", offs, wb, wl, essential,
                  prefix_beta, skip, th_lo, _scalar(alpha), _scalar(beta),
                  _scalar(gamma), b=offs.shape[0], c=offs.shape[1],
                  tile_size=tile_size)
    guided_score_chunk.launches += 1
    return out


def _launch_q(fn_name: str, words, qb_row, ql_row, meta_i, meta_f, qw_b,
              qw_l, essential, prefix_beta, skip, th_lo, alpha, beta, gamma,
              *, b: int, c: int, tile_size: int) -> torch.Tensor:
    """Validate the raw q8 inputs and launch one kernel on the current
    stream."""
    dev = words.device
    nq, wp = words.shape[-2:]
    p = qb_row.shape[-1]
    lead = (b, c) if skip is not None else (b,)
    _check("words", words, torch.int32, lead + (nq, wp), dev)
    for name, t in (("qb_row", qb_row), ("ql_row", ql_row)):
        _check(name, t, torch.uint8, lead + (nq, p), dev)
    _check("meta_i", meta_i, torch.int32, lead + (3, nq), dev)
    _check("meta_f", meta_f, torch.float32, lead + (4, nq), dev)
    for name, t in (("qw_b", qw_b), ("qw_l", qw_l)):
        _check(name, t, torch.float32, (b, nq), dev)
    for name, t in (("essential", essential), ("prefix_beta", prefix_beta)):
        _check(name, t, torch.float32, lead + (nq,), dev)
    _check("th_lo", th_lo, torch.float32, (b,), dev)
    if skip is not None:
        _check("skip", skip, torch.int32, (b, c), dev)
    if tile_size < 1:
        raise ValueError(f"tile_size={tile_size} must be >= 1")
    out = torch.empty(lead + (N_ROWS_Q, tile_size), dtype=torch.float32,
                      device=dev)
    block_s = (chunk_lane_width(nq, tile_size, b * c) if skip is not None
               else tile_lane_width(nq, tile_size))
    return _call("guided_score_tile.cu", fn_name,
                 (words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l,
                  essential, prefix_beta, skip, th_lo),
                 (alpha, beta, gamma), out, (b, c, nq, wp, p, tile_size),
                 block_s)


def guided_score_tile_q(words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l,
                        essential, prefix_beta, th_lo, alpha, beta, gamma,
                        *, tile_size: int):
    """Decode and score one q8 tile per query -> [B, 6, S].

    ``words`` [B, Nq, Wp] int32, ``qb_row``/``ql_row`` [B, Nq, P] uint8,
    ``meta_i`` [B, 3, Nq] int32, ``meta_f`` [B, 4, Nq] f32 (from
    ``gather_tile_q_raw``), ``qw_b``/``qw_l``/``essential``/``prefix_beta``
    [B, Nq] f32, ``th_lo`` [B] f32. Rows 0-4 as ``guided_score_tile``, row
    5 the valid postings per slot. CPU tensors run the plain version; CUDA
    tensors launch the kernel (counted in ``.launches``)."""
    if _device_of(words) == "cpu":
        return guided_score_tile_q_plain(
            words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l, essential,
            prefix_beta, th_lo, alpha, beta, gamma, tile_size=tile_size)
    out = _launch_q("guided_score_tile_q_launch", words, qb_row, ql_row,
                    meta_i, meta_f, qw_b, qw_l, essential, prefix_beta, None,
                    th_lo, _scalar(alpha), _scalar(beta), _scalar(gamma),
                    b=words.shape[0], c=1, tile_size=tile_size)
    guided_score_tile_q.launches += 1
    return out


def guided_score_chunk_q(words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l,
                         essential, prefix_beta, skip, th_lo, alpha, beta,
                         gamma, *, tile_size: int):
    """Decode and score a chunk of C q8 tiles per query -> [B, C, 6, S].

    Raw rows [B, C, ...] as ``guided_score_tile_q`` takes them per tile,
    ``qw_b``/``qw_l`` [B, Nq] f32, ``essential``/``prefix_beta`` [B, C, Nq]
    f32 (chunk-start thresholds), ``skip`` [B, C] int32 (nonzero = publish
    zeros), ``th_lo`` [B] f32. CPU tensors run the plain version; CUDA
    tensors launch the kernel (counted in ``.launches``)."""
    if _device_of(words) == "cpu":
        return guided_score_chunk_q_plain(
            words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l, essential,
            prefix_beta, skip, th_lo, alpha, beta, gamma,
            tile_size=tile_size)
    out = _launch_q("guided_score_chunk_q_launch", words, qb_row, ql_row,
                    meta_i, meta_f, qw_b, qw_l, essential, prefix_beta, skip,
                    th_lo, _scalar(alpha), _scalar(beta), _scalar(gamma),
                    b=words.shape[0], c=words.shape[1], tile_size=tile_size)
    guided_score_chunk_q.launches += 1
    return out


guided_score_tile.launches = 0
guided_score_chunk.launches = 0
guided_score_tile_q.launches = 0
guided_score_chunk_q.launches = 0

KERNELS = (guided_score_chunk, guided_score_tile, guided_score_chunk_q,
           guided_score_tile_q)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
