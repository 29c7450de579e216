"""Drive the PyTorch/CUDA port (``repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--seed 0] [--n-docs 1048576]

Phases, one JSON line each:

  device    the card (nvidia-smi name and power limit); stops without CUDA
  build     nvcc builds every kernel of the path from ``src/repro_torch``
            (one nvcc per source, all started together)
  index     a seeded splade_like corpus of 2^20 docs over the 30522-term
            BERT WordPiece vocabulary, indexed onto the card (fp32 BII)
  index_q8  the compressed (q8) index of the same postings, on the card
            beside the fp32 one: host build time, bytes per component and
            per doc, ratio to the fp32 bytes; tile pointers and exact
            maxima equal to the fp32 index's
  kernels   each kernel (fp32: guided_score_chunk/_tile; q8:
            guided_score_chunk_q/_tile_q) against its plain PyTorch version
            on real main-path inputs and odd shapes; times beside the
            card's bound
  serve     per index, Retriever.search on 4 batches of 16 queries at k=10
            and k=100 through the chunk kernel (traversal="chunked_fused")
            and the tile kernel (traversal="chunked"), with launch counts;
            the tile path against the plain batched path; on q8, the top-k
            overlap with the fp32 paths
  profile   one batch of each path under the profiler (device busy and idle
            share, launches, host syncs, top device ops); fp32 at k=10 and
            k=100, q8 at k=10
  rank_safe per index, a rank-safe chunked_fused run against an exhaustive
            top-k computed on the card (q8: over the dequantized postings)

Then the kernels' summary line, the nvidia-smi line and, last, the one-line
verdict. Any failed check raises and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BATCH, N_BATCHES = 16, 4
KS = (10, 100)


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, seconds since the script started, and
    the phase's fields."""
    print(json.dumps({"phase": phase,
                      "t": round(time.perf_counter() - T_START, 1),
                      **fields}), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def event_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median time of one ``fn()`` call between two CUDA events: the
    device's time plus any gap while the host prepares the launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, runs: int = 25) -> float | None:
    """Mean device time of one ``fn()`` call: the summed durations of the
    kernels (and copies) it ran on the card, from a profiler trace. None
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / runs / 1e3 if total_us > 0 else None


def timings(fn) -> dict:
    """``ms``: device time per call (profiler), or the event time when the
    profiler sees no device activity; ``event_ms`` beside it."""
    ev = event_ms(fn)
    dev = device_ms(fn)
    return {"ms": ev if dev is None else dev, "event_ms": ev,
            "timing": "events" if dev is None else "profiler"}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def random_inputs(rng, lead, nq, p, tile_size, dev):
    """Kernel inputs of the gather's form: per (row, term) a strictly
    increasing run of distinct offsets followed by -1 padding."""
    n = int(np.prod(lead))
    offs = np.full((n, nq, p), -1, np.int32)
    for r in range(n):
        for i in range(nq):
            cnt = int(rng.integers(0, min(p, tile_size) + 1))
            offs[r, i, :cnt] = np.sort(rng.choice(tile_size, cnt,
                                                  replace=False))
    valid = offs >= 0
    wb = (rng.random(offs.shape) * 3).astype(np.float32) * valid
    wl = (rng.random(offs.shape) * 5).astype(np.float32) * valid
    ess = (rng.random((n, nq)) < 0.5).astype(np.float32)
    pbeta = np.cumsum(rng.random((n, nq)), -1).astype(np.float32)

    def t(a, shape):
        return torch.from_numpy(np.ascontiguousarray(a)).reshape(shape).to(dev)
    return (t(offs, lead + (nq, p)), t(wb, lead + (nq, p)),
            t(wl, lead + (nq, p)), t(ess, lead + (nq,)),
            t(pbeta, lead + (nq,)))


# gap width -> the least encoded value (gap - 1) that needs it
WIDTH_MIN = {1: 1, 2: 2, 4: 4, 8: 16, 16: 256}


def random_q8_rows(rng, lead, nq, p, s, dev):
    """Raw q8 rows [*lead, ...] of real encoded runs (``encode_runs``, one
    term per (row, term) of a one-tile index of S >= 384 docs), fetched by
    ``gather_tile_q_raw`` at ``pad_len = p``. Run r has gap width
    ``list(WIDTH_MIN)[r % 5]``; the first three runs hold 0, 1 and
    min(P, S) postings. Past a run's end the rows hold the next run's words
    and codes, as on the main path."""
    from repro_torch.index import (encode_runs, from_encoded_grids,
                                   gather_tile_q_raw)
    n = int(np.prod(lead)) * nq
    locs = []
    for r in range(n):
        lo = list(WIDTH_MIN.values())[r % len(WIDTH_MIN)]
        gaps = rng.integers(0, lo + 1, size=p) + 1
        gaps[0] = lo + 1
        loc = int(rng.integers(0, s // 8)) + np.concatenate(
            [[0], np.cumsum(gaps)])
        loc = loc[loc < s][:int(rng.integers(2, p + 1))]
        if r < 3:
            loc = np.arange(min(p, s))[:(0, 1, p)[r]]
        locs.append(loc)
    cnt = np.array([len(x) for x in locs], np.int64)
    run_of = np.repeat(np.arange(n), cnt)
    w_b = (rng.random(cnt.sum()) * 3).astype(np.float32)
    w_l = (rng.random(cnt.sum()) * 5).astype(np.float32)
    enc = encode_runs(np.concatenate(locs), w_b, w_l, run_of, cnt)
    tmax = [np.zeros((n, 1), np.float32) for _ in range(2)]
    for tm, w in zip(tmax, (w_b, w_l)):
        np.maximum.at(tm[:, 0], run_of, w)
    index = from_encoded_grids(
        s, n, s, cnt[:, None], enc["words"][:, None], enc["packed"],
        enc["qb"], enc["ql"], enc["width"], enc["first"], enc["scale_b"],
        enc["zero_b"], enc["scale_l"], enc["zero_l"], *tmax, device=dev)
    terms = torch.arange(n, dtype=torch.int32, device=dev).reshape(
        lead + (nq,))
    return gather_tile_q_raw(index.gather_arrays(), terms,
                             torch.zeros(lead, dtype=torch.int32, device=dev),
                             pad_len=p)


def compare(name, out_k, out_p) -> float:
    """Masks (rows 3-4) and q8's postings per slot (row 5) identical, rows
    0-2 within 1e-5 * max|plain|."""
    require(out_k.shape == out_p.shape, f"{name}: shape {tuple(out_k.shape)}"
            f" != {tuple(out_p.shape)}")
    require(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    require(torch.equal(out_k[..., 3:, :], out_p[..., 3:, :]),
            f"{name}: masks or posting counts differ")
    err = (out_k[..., :3, :] - out_p[..., :3, :]).abs().max().item()
    scale = out_p[..., :3, :].abs().max().item()
    require(err <= 1e-5 * scale, f"{name}: max|d| {err} > 1e-5 * {scale}")
    return err


def bound(nbytes: int, live_tiles: int, nq: int, tile_size: int,
          extra_ops: int = 0) -> dict:
    """Least time for the same work on an H100 SXM: ``nbytes`` over the
    memory rate against the float32 operations of the freeze loop and the
    combines (about 5 per slot and term, 6 per slot for the outputs) plus
    ``extra_ops``, over the float32 rate."""
    ops = live_tiles * tile_size * (5 * nq + 6) + extra_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def bound_fp32(x, tile_size: int) -> dict:
    """K1/K2: each posting of a live tile read once (offs, wb, wl: 12 B)
    plus one padding entry per run, the planner rows (essential,
    prefix_beta), skip flags and th_lo read once, 20 B of output per slot
    of every tile written once."""
    offs = x.rows[0]
    live = ~x.skip
    n_post = int(((offs >= 0) & live[..., None, None]).sum())
    n_live, n_all = int(live.sum()), live.numel()
    nq, b = offs.shape[-2], x.th_lo.numel()
    nbytes = (12 * n_post + 4 * nq * n_live + 8 * nq * n_live
              + (4 * n_all if x.skip.dim() > 1 else 0) + 4 * b
              + 20 * tile_size * n_all)
    return {**bound(nbytes, n_live, nq, tile_size), "postings": n_post,
            "live_tiles": n_live, "shape": list(offs.shape)}


def bound_q8(x, tile_size: int) -> dict:
    """K3/K4: per live run the packed words its gaps need, 2 B of codes per
    valid posting and its metadata (cnt, first, width, zero/scale pairs:
    28 B); the query weights, planner rows, skip flags and th_lo read once;
    24 B of output per slot of every tile written once. Operations: the
    freeze loop and combines plus the dequantization (6 per posting)."""
    meta_i = x.rows[3]
    live = ~x.skip
    cnt = meta_i[..., 0, :].long() * live[..., None]
    width = meta_i[..., 2, :].long()
    words = int(((cnt - 1).clamp(min=0) * width + 31).div(
        32, rounding_mode="floor").sum())
    n_post = int(cnt.sum())
    n_live, n_all = int(live.sum()), live.numel()
    nq, b = meta_i.shape[-1], x.th_lo.numel()
    nbytes = (4 * words + 2 * n_post + 28 * nq * n_live + 8 * nq * b
              + 8 * nq * n_live + (4 * n_all if x.skip.dim() > 1 else 0)
              + 4 * b + 24 * tile_size * n_all)
    return {**bound(nbytes, n_live, nq, tile_size, 6 * n_post),
            "postings": n_post, "words": words, "live_tiles": n_live,
            "shape": list(x.rows[1].shape)}


def main_path_inputs(index, corpus, dev):
    """One real chunk and one real tile of the main path: batch 0 under the
    fast preset, after its first chunk has set the thresholds. Returns the
    context and the chunk's and the tile's StepInputs."""
    from repro_torch.core import twolevel
    from repro_torch.core.plan import chunk_schedule
    from repro_torch.core.traversal import (Carry, _chunk_step_fused,
                                            make_context, step_inputs)
    params = twolevel.fast()
    rows = slice(0, BATCH)
    q = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
         for a in (corpus.queries, corpus.q_weights_b, corpus.q_weights_l)]
    ctx = make_context(index, *q, params, k=KS[0], use_kernel=True)
    chunks, _ = chunk_schedule(ctx.plan, index.tile_max_b, index.tile_max_l,
                               ctx.alpha, index.n_tiles, params.chunk_tiles)
    carry = _chunk_step_fused(ctx, Carry.init(BATCH, ctx.k, dev),
                              chunks[:, 0], index.n_tiles)
    second = chunks[:, min(1, chunks.shape[1] - 1)]
    return (ctx, step_inputs(ctx, carry, second, index.n_tiles),
            step_inputs(ctx, carry, second[:, 0]))


def kernel_args(ctx, x, chunk: bool) -> tuple:
    """A kernel's positional arguments from main-path StepInputs."""
    qw = (ctx.plan.qwb, ctx.plan.qwl) if ctx.raw_q8 else ()
    skip = (x.skip.to(torch.int32),) if chunk else ()
    return (*x.rows, *qw, x.essential.float(), x.prefix_beta, *skip,
            x.th_lo, ctx.alpha, ctx.beta, ctx.gamma)


def phase_kernels(indexes, corpus, dev):
    from repro_torch.core.traversal import Carry, step_inputs
    from repro_torch.kernels import guided_score as gs

    S = indexes["fp32"].tile_size
    main = {}
    for label, (chunk_name, tile_name) in (
            ("fp32", ("guided_score_chunk", "guided_score_tile")),
            ("q8", ("guided_score_chunk_q", "guided_score_tile_q"))):
        ctx, x1, x2 = main_path_inputs(indexes[label], corpus, dev)
        bnd = bound_q8 if label == "q8" else bound_fp32
        for name, x, chunk in ((chunk_name, x1, True),
                               (tile_name, x2, False)):
            args = kernel_args(ctx, x, chunk)
            kern = getattr(gs, name)
            plain = getattr(gs, name + "_plain")
            main[name] = (functools.partial(kern, *args, tile_size=S),
                          functools.partial(plain, *args, tile_size=S),
                          bnd(x, S))
        if label == "q8":
            # the chunk schedule's sentinel tile: every run empty
            sentinel = kernel_args(ctx, step_inputs(
                ctx, Carry.init(BATCH, ctx.k, dev),
                torch.full((BATCH,), indexes[label].n_tiles,
                           dtype=torch.int32, device=dev)), False)
            out = gs.guided_score_tile_q(*sentinel, tile_size=S)
            compare("guided_score_tile_q sentinel", out,
                    gs.guided_score_tile_q_plain(*sentinel, tile_size=S))
            require(not bool(out.any()), "sentinel tile: nonzero output")
    errs = {name: compare(f"{name} main", kern(), plain())
            for name, (kern, plain, _) in main.items()}
    torch.cuda.synchronize()

    # Odd shapes: Nq not a power of 2, P < S, S below block_s, S not a
    # multiple of block_s, a fully skipped chunk, Nq large enough that the
    # launcher must shrink block_s to fit shared memory; for q8 also runs
    # of 0, 1 and P postings and every gap width.
    rng = np.random.default_rng(1234)
    sweep = []
    for (b, c, nq, p, s, skip_mode) in [
            (3, 4, 5, 96, 384, "mixed"), (4, 2, 7, 300, 1000, "mixed"),
            (2, 3, 16, 64, 2048, "all"), (2, 2, 64, 128, 1024, "none"),
            (1, 1, 1, 8, 64, "none"), (2, 2, 16, 2048, 2048, "none")]:
        skip = {"all": np.ones((b, c)), "none": np.zeros((b, c)),
                "mixed": rng.random((b, c)) < 0.4}[skip_mode]
        skip = torch.from_numpy(skip.astype(np.int32)).to(dev)
        th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(dev)
        th[0] = -math.inf
        offs, wb, wl, ess, pb = random_inputs(rng, (b, c), nq, p, s, dev)
        row = {"shape": [b, c, nq, p, s], "skip": skip_mode}
        cases = [("chunk", (offs, wb, wl), ())]
        if s >= 384:
            qw = torch.from_numpy(rng.random((2, b, nq)).astype(np.float32)
                                  * 2).to(dev)
            qw[:, :, -1] = 0.0                      # a padded query term
            rows = random_q8_rows(rng, (b, c), nq, p, s, dev)
            require(set(rows[3][..., 2, :].unique().tolist())
                    == set(WIDTH_MIN), "q8 sweep: a gap width is missing")
            cases.append(("chunk_q", rows, tuple(qw)))
        for kind, rows, qw in cases:
            args = (*rows, *qw, ess, pb, skip, th, 0.7, 0.2, 0.05)
            kname = "guided_score_" + kind
            row[kind + "_err"] = compare(
                f"{kind} {b}x{c}x{nq}x{p} S={s}",
                getattr(gs, kname)(*args, tile_size=s),
                getattr(gs, kname + "_plain")(*args, tile_size=s))
            targs = (*(t[:, 0].contiguous() for t in rows), *qw,
                     ess[:, 0].contiguous(), pb[:, 0].contiguous(), th, 1.0,
                     0.3, 0.05)
            tname = kname.replace("chunk", "tile")
            row[kind.replace("chunk", "tile") + "_err"] = compare(
                f"{tname} {b}x{nq}x{p} S={s}",
                getattr(gs, tname)(*targs, tile_size=s),
                getattr(gs, tname + "_plain")(*targs, tile_size=s))
        sweep.append(row)
    torch.cuda.synchronize()

    result = {}
    for name, (kern, plain, bnd) in main.items():
        t_plain = timings(plain)
        result[name] = {"max_abs_err": errs[name], **timings(kern),
                        "plain_ms": t_plain["ms"],
                        "plain_event_ms": t_plain["event_ms"], **bnd}
    emit("kernels", main=result, sweep=sweep,
         tolerance="masks and posting counts identical; rows 0-2 max|d| "
                   "<= 1e-5*max|plain|")
    return result


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

def exhaustive_topk(postings, n_docs, tile_lo, tile_hi, qt, qwb, qwl, gamma,
                    k):
    """Exact top-k of the gamma-combined score of one query: every posting
    of its terms (``postings`` = flat docids, w_b, w_l on the card)
    scatter-added (float64) into a dense [n_docs] row on the card; ties by
    ascending docid. Returns (ids, scores, dense scores)."""
    docids, w_b, w_l = postings
    s = torch.zeros(n_docs, dtype=torch.float64, device=docids.device)
    for t, wbq, wlq in zip(qt.tolist(), qwb.tolist(), qwl.tolist()):
        lo, hi = tile_lo[t], tile_hi[t]
        s.index_add_(0, docids[lo:hi].long(),
                     gamma * wbq * w_b[lo:hi].double()
                     + (1.0 - gamma) * wlq * w_l[lo:hi].double())
    s = s.float()
    vals, ids = torch.sort(s, descending=True, stable=True)
    return ids[:k].cpu().numpy(), vals[:k].cpu().numpy(), s


def check_rank_safe(resp, postings, n_docs, corpus, rows, gamma, tile_lo,
                    tile_hi):
    """Traversal top-k == exhaustive top-k: scores within rtol 2e-5 /
    atol 1e-4; ids equal except where exhaustive scores tie within that
    tolerance (visit order vs docid order)."""
    mismatched = 0
    for j, qi in enumerate(range(rows.start, rows.stop)):
        ids_x, vals_x, dense = exhaustive_topk(
            postings, n_docs, tile_lo, tile_hi,
            torch.from_numpy(corpus.queries[qi]),
            torch.from_numpy(corpus.q_weights_b[qi]),
            torch.from_numpy(corpus.q_weights_l[qi]), gamma, resp.k)
        np.testing.assert_allclose(resp.scores[j], vals_x, rtol=2e-5,
                                   atol=1e-4)
        ids_t = resp.ids[j]
        require(len(set(ids_t.tolist())) == len(ids_t), "duplicate ids")
        diff = ids_t != ids_x
        if diff.any():
            got = dense[torch.from_numpy(ids_t[diff].astype(np.int64)).to(
                dense.device)].cpu().numpy()
            np.testing.assert_allclose(got, vals_x[diff], rtol=2e-5,
                                       atol=1e-4)
            mismatched += int(diff.sum())
    return mismatched


def dequantized_postings(q8, docids):
    """The q8 index's postings as the kernels see them: docids (those of
    the fp32 index: the docid codec is lossless and the posting order the
    same) and ``zero[run] + scale[run] * q`` in float32 per posting."""
    cnt = (q8.tile_ptr[:, 1:] - q8.tile_ptr[:, :-1]).flatten()
    run = torch.repeat_interleave(
        torch.arange(cnt.numel(), device=cnt.device), cnt,
        output_size=q8.nnz)

    def deq(codes, zero, scale):
        return (zero.flatten()[run].float()
                + scale.flatten()[run].float() * codes.float())
    return (docids, deq(q8.qb, q8.zero_b, q8.scale_b),
            deq(q8.ql, q8.zero_l, q8.scale_l))


def run_batches(retriever, corpus, k):
    out = []
    for i in range(N_BATCHES):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        out.append(retriever.search(terms=corpus.queries[rows],
                                    weights_b=corpus.q_weights_b[rows],
                                    weights_l=corpus.q_weights_l[rows], k=k))
    return out


def summarize(resps):
    return [{"batch_ms": r.latency_ms, "mrt_ms": r.latency_ms / BATCH,
             "tiles_visited": float(r.stats["tiles_visited"].mean()),
             "chunks_dispatched": float(r.stats["chunks_dispatched"].mean()),
             "n_chunks": float(r.stats["n_chunks"][0])} for r in resps]


def profile_search(retriever, corpus, k) -> dict:
    """One batch of ``retriever.search`` under the profiler: wall time, the
    device's busy time (kernels and copies, one stream, so they do not
    overlap), its idle share, launches, host syncs and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = dict(terms=corpus.queries[:BATCH], weights_b=corpus.q_weights_b[
        :BATCH], weights_l=corpus.q_weights_l[:BATCH])
    retriever.search(**q, k=k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retriever.search(**q, k=k)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    host = {e.key: e.count for e in events
            if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                         "cudaMemcpyAsync", "cudaDeviceSynchronize")}
    return {"k": k, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in dev), "host_calls": host,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]}


# the two kernel paths of each index: (kernel, traversal)
PATHS = {"fp32": (("guided_score_chunk", "chunked_fused"),
                  ("guided_score_tile", "chunked")),
         "q8": (("guided_score_chunk_q", "chunked_fused"),
                ("guided_score_tile_q", "chunked"))}
# Depths profiled per index. A profiled k=100 batch of a tile path traces
# about 100k device ops and costs some 100 s of host time, so the q8
# paths are profiled at k=10 only (listed in the index phase's `reduced`).
PROFILE_KS = {"fp32": KS, "q8": KS[:1]}


def phase_serve(label, index, corpus, dev):
    """Serve 4 batches at each k through both kernel paths of one index;
    each path's launch counts are set to 0 just before its batches and
    read just after. Returns the counts and the responses."""
    from repro_torch.core import twolevel
    from repro_torch.core.traversal import STAT_KEYS
    from repro_torch.kernels import guided_score as gs
    from repro_torch.retrieval import Retriever

    fast = twolevel.fast()
    paths = [(name, Retriever.open(index, fast, engine="kernel",
                                   traversal=traversal, device=dev))
             for name, traversal in PATHS[label]]
    r_plain = Retriever.open(index, fast, engine="batched",
                             traversal="chunked", device=dev)
    for _, r in paths:          # first-call set-up (allocator, launches)
        r.search(terms=corpus.queries[:BATCH],
                 weights_b=corpus.q_weights_b[:BATCH],
                 weights_l=corpus.q_weights_l[:BATCH], k=KS[0])

    launches, served = {}, {}
    for name, r in paths:
        gs.reset_launches()
        resps = {k: run_batches(r, corpus, k) for k in KS}
        launches[name] = {fn.__name__: fn.launches for fn in gs.KERNELS}
        served[name] = resps
        require(launches[name][name] > 0, f"{name} never launched")
        require(sum(launches[name].values()) == launches[name][name],
                f"{label} {r.engine.traversal}: other kernels launched: "
                f"{launches[name]}")
        for k, batch in resps.items():
            for resp in batch:
                require(resp.ids.shape == (BATCH, k)
                        and bool(np.isfinite(resp.scores).all())
                        and bool((np.diff(resp.scores, axis=1) <= 0).all())
                        and bool(((resp.ids >= 0)
                                  & (resp.ids < index.n_docs)).all()),
                        f"{name} k={k}: malformed response")
        emit("serve", index=label, path=name, traversal=r.engine.traversal,
             launches=launches[name],
             launches_per_batch=launches[name][name] / (N_BATCHES * len(KS)),
             **{f"k{k}": summarize(v) for k, v in resps.items()})

    # The tile-kernel chunked path against the plain batched chunked path.
    tile_name = PATHS[label][1][0]
    for k in KS:
        for a, b in zip(served[tile_name][k],
                        run_batches(r_plain, corpus, k)):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6)
            for key in STAT_KEYS + ("chunks_dispatched", "n_chunks"):
                np.testing.assert_array_equal(a.stats[key], b.stats[key])
    emit("serve_parity", index=label,
         check=f"{tile_name} chunked == batched chunked (plain)",
         ids="identical", stats="identical", scores="rtol 1e-6")
    emit("profile", index=label,
         **{name: [profile_search(r, corpus, k) for k in PROFILE_KS[label]]
            for name, r in paths})
    return launches, served


def topk_overlap(served_a, served_b) -> dict:
    """Mean per-query share of top-k ids two runs have in common, per k."""
    out = {}
    for k in KS:
        shares = [len(set(a.tolist()) & set(b.tolist())) / k
                  for ra, rb in zip(served_a[k], served_b[k])
                  for a, b in zip(ra.ids, rb.ids)]
        out[f"k{k}"] = float(np.mean(shares))
    return out


def phase_rank_safe(label, index, postings, corpus, dev):
    """Rank-safe chunked_fused on ``index`` against the exhaustive top-k
    over ``postings`` (what the index holds), all 64 queries at each k."""
    from repro_torch.core import twolevel
    from repro_torch.retrieval import Retriever
    gamma = 0.2
    r_safe = Retriever.open(index, twolevel.original(gamma=gamma),
                            engine="kernel", traversal="chunked_fused",
                            device=dev)
    tile_lo = index.tile_ptr[:, 0].tolist()
    tile_hi = index.tile_ptr[:, -1].tolist()
    mism = {}
    for k in KS:
        mism[k] = sum(
            check_rank_safe(resp, postings, index.n_docs, corpus,
                            slice(i * BATCH, (i + 1) * BATCH), gamma,
                            tile_lo, tile_hi)
            for i, resp in enumerate(run_batches(r_safe, corpus, k)))
    emit("rank_safe", index=label, preset="original(gamma=0.2)",
         traversal="chunked_fused", queries=N_BATCHES * BATCH,
         exhaustive_over="dequantized postings" if label == "q8"
         else "fp32 postings",
         ids_differing_within_tie_tolerance={str(k): v
                                             for k, v in mism.items()},
         tolerance="rtol 2e-5, atol 1e-4")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=2 ** 20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    dev = torch.device("cuda")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    from repro_torch.core import build_index
    from repro_torch.data import make_corpus
    from repro_torch.index import compress_index
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, flags=build.NVCC_FLAGS,
         sources={s: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                  for s, v in log.items()})

    reduced = ["q8 paths profiled at k=10 only"]
    if args.n_docs != 2 ** 20:
        reduced.append(f"n_docs {args.n_docs} (of 2^20)")
    t0 = time.perf_counter()
    corpus = make_corpus("splade_like", n_docs=args.n_docs, n_terms=30522,
                         n_queries=N_BATCHES * BATCH, n_q_terms=16,
                         avg_doc_terms=16, seed=args.seed)
    t1 = time.perf_counter()
    merged = corpus.merged("scaled")
    t2 = time.perf_counter()
    index = build_index(merged, tile_size=2048, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emit("index", n_docs=index.n_docs, n_terms=index.n_terms, nnz=index.nnz,
         device_bytes=index.nbytes(), pad_len=index.pad_len,
         n_tiles=index.n_tiles, tile_size=index.tile_size,
         setup_seconds={"make_corpus": t1 - t0, "merge": t2 - t1,
                        "layout_and_upload": t3 - t2}, reduced=reduced)

    t0 = time.perf_counter()
    q8 = compress_index(merged, tile_size=2048, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del merged
    for f in ("tile_ptr", "tile_max_b", "tile_max_l", "sigma_b", "sigma_l"):
        require(torch.equal(getattr(q8, f), getattr(index, f)),
                f"q8 {f} differs from the fp32 index's")
    require((q8.nnz, q8.pad_len, q8.n_tiles) == (index.nnz, index.pad_len,
                                                 index.n_tiles),
            "q8 geometry differs from the fp32 index's")
    nb = q8.nbytes()
    widths = torch.bincount(q8.width.flatten().long(), minlength=17)
    emit("index_q8", build_seconds=t1 - t0, device_bytes=nb,
         bytes_per_doc=nb["total"] / q8.n_docs,
         fp32_device_bytes=index.nbytes(), fp32_nbytes=q8.fp32_nbytes(),
         ratio_to_fp32=nb["total"] / q8.fp32_nbytes(),
         runs_by_gap_width={str(w): int(widths[w]) for w in WIDTH_MIN},
         checks="tile_ptr, tile and list maxima identical to fp32")

    indexes = {"fp32": index, "q8": q8}
    kern = phase_kernels(indexes, corpus, dev)
    launches, served = {}, {}
    for label, idx in indexes.items():
        counts, served[label] = phase_serve(label, idx, corpus, dev)
        launches.update(counts)
    emit("serve_q8_vs_fp32",
         topk_overlap={PATHS["q8"][i][0]: topk_overlap(
             served["q8"][PATHS["q8"][i][0]],
             served["fp32"][PATHS["fp32"][i][0]]) for i in range(2)})
    phase_rank_safe("fp32", index, (index.docids, index.w_b, index.w_l),
                    corpus, dev)
    phase_rank_safe("q8", q8, dequantized_postings(q8, index.docids), corpus,
                    dev)

    src = "src/repro_torch/kernels/csrc/"
    where = {"guided_score_chunk": ("guided_score.cu", 123),
             "guided_score_tile": ("guided_score.cu", 36),
             "guided_score_chunk_q": ("guided_score_q.cu", 413),
             "guided_score_tile_q": ("guided_score_q.cu", 298)}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": f"src/repro/kernels/guided_score.py:{line}",
         "launches": launches[name][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None}
        for name, (cu, line) in where.items()]}
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
