"""Guided tile scoring: the 2GTI hot loop as hand-written CUDA for Hopper.

Two kernels, each with a plain PyTorch version of the same contract:

  - ``guided_score_tile``  [B, Nq, P] -> [B, 5, S]: one tile per query.
    Replaces the TPU kernel ``repro/kernels/guided_score.py::
    guided_score_tile`` (body ``_kernel``), which the JAX package runs
    once per (query, tile) under ``vmap``.
  - ``guided_score_chunk`` [B, C, Nq, P] -> [B, C, 5, S]: a chunk of C
    tiles per query with a per-tile skip flag. Replaces ``repro/kernels/
    guided_score.py::guided_score_chunk`` (body ``_chunk_kernel``).

Per (query, tile) both compute, over the tile's S doc slots:
  1. scatter each term's padded posting run (``offs``, -1 = padding) into
     dense rows; a slot survives when an essential term has a posting there;
  2. the descending freeze loop: before term i, a slot stays alive while
     ``essential[i]`` or ``beta*sb + (1-beta)*sl + prefix_beta[i] > th_lo``;
     surviving live slots accumulate both weights;
  3. rows Global/Local/Rank (alpha/beta/gamma combinations of the sums),
     the eval mask (survive & alive) and the rank mask (survive).
A skipped tile of a chunk publishes five zero rows.

Dispatch is by the tensors' device: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel (or raises). There is no fallback.

Inputs are as ``core.index.gather_tile`` produces them: each (row, term)
run is a strictly increasing sequence of distinct slots followed by -1
padding. The kernel relies on both (each (term, slot) gets at most one
posting; a run ends at its first -1).

Bound on an H100 SXM (3.35 TB/s): memory-bound. The padded inputs are
``12*Nq*P`` bytes per live (query, tile) and the output ``20*S`` bytes; at
Nq = 16, P = S = 2048 that is about 0.43 MB, 0.13 us. A run is read only
up to its first padding entry, so the bytes the work needs are 12 per
valid posting plus the output; ``chip_smoke.py`` computes that bound from
each run's data. The design stores each posting straight into shared
memory (no atomics: one posting per (term, slot); the TPU's one-hot
matrix product is not needed), keeps the dense rows out of device
memory, and writes each output element once. A skipped tile costs one
flag read and its zero rows.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

N_ROWS = 5          # Global, Local, Rank, eval mask, rank mask
# Doc slots per thread block: 16 terms x 512 slots x 2 weights x 4 B = 64 KB
# of shared memory; the launcher halves it when more terms would not fit.
BLOCK_S = 512


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


def _launch(fn_name: str, offs, wb, wl, essential, prefix_beta, skip, th_lo,
            alpha, beta, gamma, *, b: int, c: int,
            tile_size: int) -> torch.Tensor:
    """Validate the inputs and launch one kernel on the current stream."""
    from . import build
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
    if out.numel() == 0:
        return out
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            ptr(offs.data_ptr()), ptr(wb.data_ptr()), ptr(wl.data_ptr()),
            ptr(essential.data_ptr()), ptr(prefix_beta.data_ptr()),
            ptr(skip.data_ptr() if skip is not None else None),
            ptr(th_lo.data_ptr()), ctypes.c_float(alpha),
            ctypes.c_float(beta), ctypes.c_float(gamma),
            ptr(out.data_ptr()), b, c, nq, p, tile_size, BLOCK_S,
            ptr(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {build.error_string(rc)} "
                           f"(cudaError {rc})")
    return out


def _device_of(offs: torch.Tensor) -> str:
    if offs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"guided_score: unsupported device {offs.device}")
    return offs.device.type


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


guided_score_tile.launches = 0
guided_score_chunk.launches = 0

KERNELS = (guided_score_chunk, guided_score_tile)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
