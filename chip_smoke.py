"""Drive the PyTorch/CUDA port (``repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--seed 0] [--n-docs 1048576]

Phases, one JSON line each:

  device    the card (nvidia-smi name and power limit); stops without CUDA
  build     nvcc builds every kernel of the path from ``src/repro_torch``
            (one nvcc per source, all started together); the f32 route's
            library must hold TF32 mma instructions (``cuobjdump -sass``:
            HMMA.1688.F32.TF32)
  index     a seeded splade_like corpus of 2^20 docs over the 30522-term
            BERT WordPiece vocabulary, indexed onto the card (fp32 BII);
            made by ``eval.make_graded_corpus`` (its postings and queries
            are ``make_corpus``'s), which adds 256-dim document
            embeddings and a query-term projection for the hybrid phase
  index_q8  the compressed (q8) index of the same postings, on the card
            beside the fp32 one: host build time, bytes per component and
            per doc, ratio to the fp32 bytes; tile pointers and exact
            maxima equal to the fp32 index's
  stream_build  the same corpus streamed in 8 chunks of 2^17 docs
            (``iter_chunks``) through ``StreamingIndexBuilder`` into a
            temporary directory and finalized onto the card: every tensor
            equal to the index_q8 phase's; add_chunk and finalize seconds,
            spill bytes, bytes on the card; then served through K3
            (chunked_fused) and K4 (chunked) by Retrievers opened with a
            ``MetricsRegistry``, 4 batches of 16 at k=10 and k=100, ids,
            scores, stats and launch counts bit-equal to the same searches
            on the index_q8 index; the ``search_ms/kernel`` histogram (one
            sample per search) and each batch's traversal trace attributes
            (``obs.trace_exec.request_attributes``)
  kernels   each kernel (fp32: guided_score_chunk/_tile; q8:
            guided_score_chunk_q/_tile_q, all four in
            ``guided_score_tile.cu``) against its plain PyTorch version
            on real main-path inputs and odd shapes, bit for bit; times
            beside the card's bound and, on the same inputs in turns, a
            launch that only writes zero rows (``floor_ms``: the chunk
            launcher with every skip flag set; for a tile kernel, on the
            tile as a chunk of one tile); the chunk kernels also at each
            lane width of CHUNK_WIDTHS (``lane_width_ms``)
  serve     per index, Retriever.search on 4 batches of 16 queries at k=10
            and k=100 through the chunk kernel (traversal="chunked_fused")
            and the tile kernel (traversal="chunked"), with launch counts;
            the tile path against the plain batched path; on q8, the top-k
            overlap with the fp32 paths
  profile   one batch of each path under the profiler (device busy and idle
            share, launches, host syncs, top device ops, the port's own
            kernels); fp32 at k=10 and k=100, q8 at k=10
  serve_sched  the serving layer (``repro_torch.serve``) on the fp32 index:
            ``table8_policy(long_engine="kernel",
            long_traversal="chunked_fused")`` (short route: <= 4 live
            terms, the plain batched chunked scan at width 4; long route:
            K1) under ``original(gamma=0.2)``, SchedulerConfig(max_batch=16,
            pad_terms=16, cache_size=256), k-buckets 10 and 100, a
            256-request ``mixed_request_stream`` (32 queries, 3 and 16
            terms, k 10 and 100). Step 1 synchronous (submit all, flush):
            every response bit-equal to a per-request search on its
            route, K1 launched by the long route alone, the replay served
            from the cache; step 2 threaded, 1 and 2 executors (one CUDA
            stream each) at half step 1's rate (``run_workload``), each
            response equal to step 1's, then a saturating burst of 64
            requests with the cache off; step 3 ``swap_index(q8)`` while a
            2-executor pool serves the stream at step 1's rate:
            generation-1 responses equal per-request
            searches on q8 (K3), no cache hit across generations; step 4
            one injected batch failure retried once, traced (a request
            span per request, ``chunks_dispatched`` on each execute span)
  sharded   the fp32 and q8 indexes partitioned into 4 tile-range shards
            (``shard_index``: host repack seconds, bytes on the card,
            padding share) and served through ``Retriever.open(...,
            engine="sharded", use_kernel=True)`` on one batch of 16:
            rank-safe (``original(gamma=0.2)``, full, docid schedule,
            exchange every 0 and 64 tiles) ids and scores bit-equal to the
            single-device tile kernel's search at k=10 and k=100 (q8: k=10);
            guided (``fast()``) chunked bit-equal to the per-shard
            impact-ordered full scan, its chunk and tile counters beside
            the single-device chunked path's; one profiled fp32 chunked
            batch; the collective path on an NCCL group of one rank equal
            to the emulation at one shard. Every sharded search launches
            its index's tile kernel (K2, K4) and no other
  rank_safe per index, a rank-safe chunked_fused run against an exhaustive
            top-k computed on the card (q8: over the dequantized postings)
  hybrid    dense guided retrieval and the hybrid engines at 2^20 docs x
            256 dims: ``build_hybrid`` over the fp32 index (and the same
            dense side over q8), ``build_dense_index`` at its defaults;
            build seconds and bytes; 4 batches of 16 at k=10 and k=100
            under original(gamma=0.2) and fast(): ``cascade`` (k'=100,
            K1) and ``rrf`` (k'=100, K3) equal to their first stage
            composed by hand (rerank scores within 1e-5 of float64,
            ``dense_topk`` equal to a float64 host top-k off ties), only
            K1 / K3 launched; ``dense`` rank-safe equal to
            ``exhaustive_dense`` off ties, guided within the score
            tolerance of the CPU; quality (MRR@10, nDCG@10, R@10, R@100)
            next to MRT and p99 per lane (``evaluate_retriever``, 64
            judged queries); one profiled cascade and dense batch
  lm        granite-3-2b at full width (fp32 master, bf16 compute):
            prefill of 4 x 4096 prompts into a 4128-position cache and 32
            greedy decode steps through flash_attention (prefill on its
            "mma" route, decode on "split"), with launch counts by route,
            bytes, a profile of each, and the last 8 steps against a
            cache-free forward (logits within 2% of max |ref|; argmax
            identical where the reference's top-2 margin exceeds twice the
            measured max |d|); K6 at decode also timed on inputs that
            rotate over the 40 layers' caches (1.35 GB, past the L2)
  lm_f32    the same model in float32 compute (the reference's smoke
            configs' dtype): prefill 4 x 128, 8 decode steps, every K6
            call on its "f32" route (3xTF32 on the tensor cores), against
            a cache-free forward; K6 checked and timed on the layer-0
            inputs of the prefill and of a decode step, also within
            ``fa.three_pass_bound`` (2e-5 + 2e-5 |plain|), where the same
            attention with one TF32 pass per product must fail it
  recsys    dlrm-rm2, two-tower-retrieval and bert4rec at full width:
            serve_p99 (batch 512) and retrieval_cand (1,000,448 candidates,
            top-100) through embedding_bag / flash_attention, each against
            the same step on the CPU
  kernels_models  flash_attention (routes mma, split and f32) and
            embedding_bag against their plain versions on the main path's
            inputs (captured from the lm and recsys runs, where a zeroed
            output and one without each row's last key tile are shown to
            fail the route's tolerance) and odd shapes, each K6 case with
            its route; times beside the bound, the plain version and one
            PyTorch library call on the same inputs; K5's odd shapes
            include two on its scalar path (D 3, a table off a 16-byte
            boundary)

Then the six kernels' summary line (flash_attention once, with its routes
mma, split and f32; K1 and K3 also with their serve_sched and hybrid
launches, K2 and K4 with their sharded launches), the
nvidia-smi line and, last, the one-line verdict.
Any failed check raises and the script exits non-zero.
Float32 matrix products run in full float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
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


def sass_count(library: str, opcode: str) -> int:
    """Lines of ``opcode`` in the SASS of a built library (``cuobjdump``
    from the CUDA toolkit that holds nvcc)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", library],
                          capture_output=True, text=True, timeout=120,
                          check=True)
    return proc.stdout.count(opcode)


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


def spin_cycles_per_ms() -> float:
    """Clock cycles the card's spin kernel (``torch.cuda._sleep``) takes
    per millisecond, measured once between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 7)
    stop.record()
    stop.synchronize()
    return 10 ** 7 / start.elapsed_time(stop)


def device_ms(fn, cycles_per_ms: float, runs: int = 25) -> dict:
    """Mean time of one ``fn()`` call on the card: CUDA events around
    ``runs`` calls queued behind a spin kernel that lasts longer than the
    host takes to queue them, so the card runs them back to back and the
    host's launch overhead is hidden (the gaps between kernels are
    counted). ``host_bound`` says the host's queueing outlasted the spin
    (then the time includes host gaps)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * queue_ms + 1.0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * spin_ms))
    t0 = time.perf_counter()
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    stop.synchronize()
    return {"ms": start.elapsed_time(stop) / runs,
            "host_bound": queued_ms > spin_ms}


@functools.lru_cache(maxsize=None)
def _cycles_per_ms() -> float:
    return spin_cycles_per_ms()


def timings(fn) -> dict:
    """``ms``: device time per call, back to back (``device_ms``);
    ``event_ms``: one call between events, the host's launch included."""
    return {**device_ms(fn, _cycles_per_ms()), "event_ms": event_ms(fn),
            "timing": "events, back to back behind a spin kernel"}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def random_inputs(rng, lead, nq, p, tile_size, dev, full_every=0):
    """Kernel inputs of the gather's form: per (row, term) a strictly
    increasing run of distinct offsets followed by -1 padding; with
    ``full_every``, every such run (counted over rows and terms) holds
    min(P, S) postings."""
    n = int(np.prod(lead))
    offs = np.full((n, nq, p), -1, np.int32)
    for r in range(n):
        for i in range(nq):
            cnt = int(rng.integers(0, min(p, tile_size) + 1))
            if full_every and (r * nq + i) % full_every == 0:
                cnt = min(p, tile_size)
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
    0-2 bit-equal (every product and sum rounded as the plain version
    rounds it). Returns max|d| of rows 0-2, which must be 0."""
    require(out_k.shape == out_p.shape, f"{name}: shape {tuple(out_k.shape)}"
            f" != {tuple(out_p.shape)}")
    require(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    require(torch.equal(out_k[..., 3:, :], out_p[..., 3:, :]),
            f"{name}: masks or posting counts differ")
    err = (out_k[..., :3, :] - out_p[..., :3, :]).abs().max().item()
    require(torch.equal(out_k[..., :3, :], out_p[..., :3, :]),
            f"{name}: rows 0-2 not bit-equal, max|d| {err}")
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


def tile_as_skipped_chunk(ctx, x) -> tuple:
    """The chunk launcher's arguments for the tile ``x`` (StepInputs of one
    tile per query) as a chunk of one tile with its skip flag set: a launch
    of the tile's grid that only writes the zero rows (K2/K4's
    ``floor_ms``)."""
    one = x._replace(rows=tuple(r.unsqueeze(1) for r in x.rows),
                     essential=x.essential.unsqueeze(1),
                     prefix_beta=x.prefix_beta.unsqueeze(1),
                     skip=torch.ones_like(x.skip).unsqueeze(1))
    return kernel_args(ctx, one, True)


def called_within(context, fn, *args):
    """``fn()`` (a wrapper's call) within ``context(*args)``: another lane
    width, for comparisons in one run."""
    with context(*args):
        return fn()


@contextlib.contextmanager
def chunk_lane_width_fixed(width: int):
    """Within the block the chunk wrappers launch at lane width ``width``
    (capped at the tile) in place of ``chunk_lane_width``'s choice."""
    from repro_torch.kernels import guided_score as gs
    choose = gs.chunk_lane_width
    gs.chunk_lane_width = lambda nq, tile_size, n_tiles: min(width,
                                                             tile_size)
    try:
        yield
    finally:
        gs.chunk_lane_width = choose


# chunk lane widths timed beside chunk_lane_width's choice (the kernels
# phase's ``lane_width_ms``)
CHUNK_WIDTHS = (128, 256, 512)


def phase_kernels(indexes, corpus, dev):
    from repro_torch.core.traversal import Carry, step_inputs
    from repro_torch.kernels import guided_score as gs

    S = indexes["fp32"].tile_size
    main, floor, ctxs = {}, {}, {}
    for label, (chunk_name, tile_name) in (
            ("fp32", ("guided_score_chunk", "guided_score_tile")),
            ("q8", ("guided_score_chunk_q", "guided_score_tile_q"))):
        ctx, x1, x2 = main_path_inputs(indexes[label], corpus, dev)
        ctxs[label] = ctx
        bnd = bound_q8 if label == "q8" else bound_fp32
        for name, x, chunk in ((chunk_name, x1, True),
                               (tile_name, x2, False)):
            args = kernel_args(ctx, x, chunk)
            kern = getattr(gs, name)
            plain = getattr(gs, name + "_plain")
            main[name] = (functools.partial(kern, *args, tile_size=S),
                          functools.partial(plain, *args, tile_size=S),
                          bnd(x, S))
        # the chunk launcher writing zero rows only: K1/K3 with every tile
        # of the chunk skipped, K2/K4 on the tile as a skipped chunk of one
        floor[chunk_name] = functools.partial(
            getattr(gs, chunk_name), *kernel_args(ctx, x1._replace(
                skip=torch.ones_like(x1.skip)), True), tile_size=S)
        floor[tile_name] = functools.partial(
            getattr(gs, chunk_name), *tile_as_skipped_chunk(ctx, x2),
            tile_size=S)
    errs = {name: compare(f"{name} main", kern(), plain())
            for name, (kern, plain, _) in main.items()}
    for name, fn in floor.items():
        require(not bool(fn().any()), f"{name} floor: nonzero output")
    torch.cuda.synchronize()

    # Odd shapes: Nq not a power of 2, P < S, S below block_s, S not a
    # multiple of block_s, a fully skipped chunk, Nq large enough that the
    # launcher must shrink block_s to fit shared memory; for q8 also runs
    # of 0, 1 and P postings and every gap width. Then the tile kernels'
    # edges: two presence-mask words (Nq 33, 64), runs longer than 32
    # postings crossing lane blocks, S not a multiple of the lane width or
    # below it, runs of exactly P (fp32: every ``full``-th run; q8: the
    # third run of each case). Then chunks large enough to take a wider
    # chunk lane width (``chunk_lane_width``, 512 or 256 here): mixed skips
    # over tiles of several lane blocks, a fully skipped chunk, Nq 33 and
    # 64, runs of exactly P = 96 and 2048 (longer than 64 postings), S not a
    # multiple of the chunk lane width and S below it (the width is then
    # S); in the q8 rows each query's C tiles hold runs of every gap width
    # and their own zero/scale pairs under the one query's weights. The q8
    # sentinel tile is the last row.
    rng = np.random.default_rng(1234)
    sweep = []
    for (b, c, nq, p, s, skip_mode, full) in [
            (3, 4, 5, 96, 384, "mixed", 0), (4, 2, 7, 300, 1000, "mixed", 0),
            (2, 3, 16, 64, 2048, "all", 0), (2, 2, 64, 128, 1024, "none", 0),
            (1, 1, 1, 8, 64, "none", 0), (2, 2, 16, 2048, 2048, "none", 0),
            (2, 2, 33, 200, 2000, "mixed", 0),
            (3, 2, 64, 512, 1500, "none", 0),
            (2, 2, 16, 2048, 2048, "none", 3),
            (2, 2, 64, 40, 2048, "none", 4), (2, 1, 5, 40, 100, "none", 0),
            (9, 8, 16, 64, 2048, "mixed", 0), (16, 8, 16, 64, 2048, "all", 0),
            (9, 8, 33, 200, 2000, "mixed", 0),
            (9, 8, 64, 512, 1500, "mixed", 0),
            (9, 8, 16, 96, 2048, "mixed", 2),
            (9, 8, 16, 2048, 2048, "mixed", 3),
            (24, 12, 16, 96, 384, "mixed", 0)]:
        skip = {"all": np.ones((b, c)), "none": np.zeros((b, c)),
                "mixed": rng.random((b, c)) < 0.4}[skip_mode]
        skip = torch.from_numpy(skip.astype(np.int32)).to(dev)
        th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(dev)
        th[0] = -math.inf
        offs, wb, wl, ess, pb = random_inputs(rng, (b, c), nq, p, s, dev,
                                              full)
        row = {"shape": [b, c, nq, p, s], "skip": skip_mode,
               "lane_width": gs.tile_lane_width(nq, s),
               "chunk_lane_width": gs.chunk_lane_width(nq, s, b * c)}
        if full:
            row["full_runs"] = int(((offs >= 0).sum(-1) == p).sum())
            require(row["full_runs"] > 0, "sweep: no run of exactly P")
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
    # the chunk schedule's sentinel tile on the q8 index: every run empty
    ctx = ctxs["q8"]
    sentinel = kernel_args(ctx, step_inputs(
        ctx, Carry.init(BATCH, ctx.k, dev),
        torch.full((BATCH,), indexes["q8"].n_tiles, dtype=torch.int32,
                   device=dev)), False)
    out = gs.guided_score_tile_q(*sentinel, tile_size=S)
    sweep.append({"shape": list(sentinel[0].shape), "skip": "sentinel tile",
                  "tile_q_err": compare(
                      "guided_score_tile_q sentinel", out,
                      gs.guided_score_tile_q_plain(*sentinel, tile_size=S))})
    require(not bool(out.any()), "sentinel tile: nonzero output")
    torch.cuda.synchronize()

    result = {}
    for name, (kern, plain, bnd) in main.items():
        t_plain = timings(plain)
        result[name] = {"max_abs_err": errs[name], **timings(kern),
                        "plain_ms": t_plain["ms"],
                        "plain_event_ms": t_plain["event_ms"], **bnd}
    for name, fn in floor.items():
        # in turns on the same inputs: kernel, write-only floor, kernel
        t_kern = [result[name]["ms"]]
        t_floor = timings(fn)["ms"]
        t_kern.append(timings(main[name][0])["ms"])
        shape = main[name][2]["shape"]
        if "chunk" in name:
            # the chunk kernel at each lane width, bit-equal, in turns
            at = {w: functools.partial(called_within, chunk_lane_width_fixed,
                                       main[name][0], w)
                  for w in CHUNK_WIDTHS}
            for w, fn in at.items():
                compare(f"{name} main at lane width {w}", fn(),
                        main[name][1]())
            runs = {w: [] for w in CHUNK_WIDTHS}
            for w in CHUNK_WIDTHS + CHUNK_WIDTHS[::-1]:
                runs[w].append(timings(at[w])["ms"])
            result[name]["lane_width_ms"] = {
                str(w): statistics.mean(v) for w, v in runs.items()}
        result[name].update(
            ms=statistics.mean(t_kern), ms_runs=t_kern, floor_ms=t_floor,
            lane_width=(gs.chunk_lane_width(shape[-2], S, math.prod(
                shape[:2])) if "chunk" in name
                else gs.tile_lane_width(shape[-2], S)))
    emit("kernels", main=result, sweep=sweep,
         tolerance="masks and posting counts identical; rows 0-2 bit-equal")
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
    """One batch of ``retriever.search`` under the profiler (``profile_call``)."""
    q = dict(terms=corpus.queries[:BATCH], weights_b=corpus.q_weights_b[
        :BATCH], weights_l=corpus.q_weights_l[:BATCH])
    return {"k": k, **profile_call(lambda: retriever.search(**q, k=k))}


def profile_call(fn, warm: bool = True) -> dict:
    """One ``fn()`` under the profiler, ending in a synchronize: wall time,
    the device's busy time (kernels and copies, one stream, so they do not
    overlap), its idle share, launches, host syncs and the kernels that
    take the most device time. ``warm``: run ``fn`` once before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    host = {e.key: e.count for e in events
            if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                         "cudaMemcpyAsync", "cudaDeviceSynchronize")}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in dev), "host_calls": host,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
            "port_kernels": [{"name": e.key[:80], "count": e.count,
                              "ms": e.self_device_time_total / 1e3}
                             for e in dev if any(
                                 k in e.key for k in PORT_KERNEL_NAMES)]}


# the __global__ functions of src/repro_torch/kernels/csrc/*.cu
PORT_KERNEL_NAMES = ("guided_score", "flash_attention", "embedding_bag")


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


# --------------------------------------------------------------------------
# serve_sched: the serving layer (scheduler, executor pool, hot swap)
# --------------------------------------------------------------------------

SCHED_REQUESTS, SCHED_POOL, SCHED_SHORT = 256, 32, 3
SCHED_KS = (10, 100)
# the saturating bursts of step 2 and the retried run of step 4 take the
# stream's first 64 requests: its 32 queries twice, one batch per group
SCHED_BURST = 64


def same_response(got, want) -> bool:
    """ids, scores and every per-query stat bit-equal."""
    return (np.array_equal(got.ids, want.ids)
            and np.array_equal(got.scores, want.scores)
            and set(got.stats) == set(want.stats)
            and all(np.array_equal(got.stats[k], want.stats[k])
                    for k in got.stats))


def per_request_refs(scheduler, index, params, stream, dev) -> list:
    """Each request searched alone on its route's configuration over
    ``index`` on the card, at the route's padded width (zero-weight
    terms), as the scheduler executes it; one search per distinct
    request."""
    from repro_torch.retrieval import Retriever
    routing, cfg = scheduler.routing, scheduler.cfg
    retr = {r.name: Retriever.open(index, params, engine=r.engine,
                                   device=dev, k_buckets=scheduler.k_buckets,
                                   **r.opts()) for r in routing.routes}
    memo, out = {}, []
    for req in stream:
        rt = routing.classify(len(req.terms))
        key = (rt.name, req.terms.tobytes(), req.k)
        if key not in memo:
            width = rt.pad_terms or cfg.pad_terms
            rows = [np.zeros((1, width), dt)
                    for dt in (np.int32, np.float32, np.float32)]
            for row, src in zip(rows, (req.terms, req.weights_b,
                                       req.weights_l)):
                row[0, :len(src)] = src
            memo[key] = retr[rt.name].search(
                terms=rows[0], weights_b=rows[1], weights_l=rows[2],
                k=req.k)
        out.append(memo[key])
    return out


def count_route_launches(scheduler, kernel) -> dict:
    """Wrap each route's master Retriever so that ``kernel``'s launches
    made inside its searches add up per route (synchronous runs only:
    the counters are not atomic across threads)."""
    by_route = {}
    for r in scheduler.routing.routes:
        retr = scheduler._retriever(r.name)
        search = retr.search

        def counted(*a, _search=search, _name=r.name, **kw):
            before = kernel.launches
            out = _search(*a, **kw)
            by_route[_name] = (by_route.get(_name, 0) + kernel.launches
                               - before)
            return out
        retr.search = counted
    return by_route


def capture_handles(scheduler) -> list:
    """The handles ``run_workload`` submits, in order."""
    handles, submit = [], scheduler.submit

    def capturing(*a, **kw):
        handles.append(submit(*a, **kw))
        return handles[-1]
    scheduler.submit = capturing
    return handles


def latency_summary(handles, wall_s) -> dict:
    from repro_torch.serve import aggregate_latencies
    return aggregate_latencies([h.latency_ms for h in handles], wall_s)


def phase_serve_sched(indexes, corpus, smi: str, dev) -> dict:
    """The serving layer on the card over the fp32 index: the table-8
    policy (short route: the plain batched chunked scan at width 4; long
    route: K1, ``chunked_fused``) under ``original(gamma=0.2)``, a
    256-request mixed stream. Step 1 synchronous, every response
    bit-equal to a per-request search; step 2 threaded (1 and 2
    executors, each on its own stream) at half step 1's rate, and a
    saturating burst of 64 requests with the cache off; step 3 a hot swap
    to the q8 index while a 2-executor pool serves the stream at step 1's
    rate (K3); step 4 one injected batch failure, retried, traced.
    Returns the launch counts of K1 (step 1) and K3 (step 3)."""
    import threading

    from repro_torch.core import twolevel
    from repro_torch.kernels import guided_score as gs
    from repro_torch.obs import Tracer
    from repro_torch.serve import (AsyncRetrievalScheduler, FaultPlan,
                                   RetryPolicy, SchedulerConfig, fail_batch,
                                   mixed_request_stream, run_workload,
                                   table8_policy)

    index, q8 = indexes["fp32"], indexes["q8"]
    t_phase = time.perf_counter()
    params = twolevel.original(gamma=0.2)
    policy = table8_policy(long_engine="kernel",
                           long_traversal="chunked_fused")
    cfg = dict(max_batch=16, pad_terms=16, cache_size=256)
    stream = mixed_request_stream(corpus, SCHED_REQUESTS,
                                  short_len=SCHED_SHORT, k_pool=SCHED_KS,
                                  query_pool=SCHED_POOL)

    def scheduler(index, faults=None, **over):
        return AsyncRetrievalScheduler(
            index, params, SchedulerConfig(**{**cfg, **over}),
            routing=policy, k_buckets=SCHED_KS, faults=faults, device=dev)

    # -- step 1: synchronous ------------------------------------------------
    s = scheduler(index)
    require(s.index is index and s.device.type == dev.type,
            "serve_sched: the scheduler copied the index")
    warm_s = s.warmup()
    by_route = count_route_launches(s, gs.guided_score_chunk)
    gs.reset_launches()
    t0 = time.perf_counter()
    handles = [s.submit(r) for r in stream]
    s.flush()
    wall1 = time.perf_counter() - t0
    launches1 = {fn.__name__: fn.launches for fn in gs.KERNELS}
    k1 = launches1["guided_score_chunk"]
    require(k1 > 0 and sum(launches1.values()) == k1,
            f"serve_sched step 1: launches {launches1}")
    require(by_route == {"short": 0, "long": k1},
            f"serve_sched step 1: K1 launches by route {by_route}")
    sync = [h.result() for h in handles]
    t0 = time.perf_counter()
    refs = per_request_refs(s, index, params, stream, dev)
    refs_s = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(sync, refs))
           if not same_response(a, b)]
    require(not bad, f"serve_sched step 1: requests {bad[:8]} differ from "
                     f"per-request searches")
    st1 = s.stats()
    replay = [s.submit(r) for r in stream]
    require(all(h.cached for h in replay)
            and all(same_response(h.result(), a)
                    for h, a in zip(replay, sync)),
            "serve_sched step 1: the replay is not served from the cache")
    rps1 = SCHED_REQUESTS / wall1
    step1 = {"wall_s": wall1, "served_rps": rps1, "warmup_s": warm_s,
             **latency_summary(handles, wall1),
             "batches_by_group": st1["batches_by_group"],
             "requests_by_route": st1["requests_by_route"],
             "rows_padding": st1["rows_padding"],
             "replay_cache_hits": s.stats()["cache_hits"],
             "k1_launches": k1, "k1_launches_by_route": by_route,
             "per_request_refs_s": refs_s,
             "check": "every response == a per-request search (ids, "
                      "scores, stats), bit for bit"}
    emit("serve_sched", step="sync", **step1)

    # -- step 2: threaded, at half step 1's rate; then a saturating burst ----
    step2 = {}
    for n_exec in (1, 2):
        s = scheduler(index, executors=n_exec)
        handles = capture_handles(s)
        with s:
            res = run_workload(s, stream, qps=0.5 * rps1, seed=0)
        bad = [i for i, (h, a) in enumerate(zip(handles, sync))
               if not same_response(h.result(), a)]
        require(len(handles) == SCHED_REQUESTS and not bad,
                f"serve_sched step 2 ({n_exec} executors): requests "
                f"{bad[:8]} differ from step 1")
        by_exec = res["batches_by_executor"]
        require(len(by_exec) == n_exec,
                f"serve_sched step 2: batches by executor {by_exec}")
        s = scheduler(index, executors=n_exec, cache_size=0)
        with s:
            t0 = time.perf_counter()
            burst = [s.submit(r) for r in stream[:SCHED_BURST]]
            for h in burst:
                h.result(timeout=300)
            wall = time.perf_counter() - t0
        step2[n_exec] = {
            "offered_qps": 0.5 * rps1,
            **{k: res[k] for k in ("n", "mrt_ms", "p50_ms", "p99_ms",
                                   "qps_achieved", "cache_hits",
                                   "batches")},
            "batches_by_executor": by_exec,
            "burst": {"wall_s": wall, "served_rps": SCHED_BURST / wall,
                      **latency_summary(burst, wall),
                      "batches_by_executor":
                          s.stats()["batches_by_executor"]}}
        emit("serve_sched", step="threaded", executors=n_exec,
             **step2[n_exec], check="every response == step 1's")

    # -- step 3: hot swap to the q8 index while a pool serves -----------------
    s = scheduler(index, executors=2)
    handles = capture_handles(s)
    swap = {}

    def swap_to_q8():
        t0 = time.perf_counter()
        swap["generation"] = s.swap_index(q8)
        swap["done"] = time.perf_counter()
        swap["k3_after"] = gs.guided_score_chunk_q.launches
        swap["seconds"] = swap["done"] - t0

    gs.reset_launches()
    timer = threading.Timer(0.35 * SCHED_REQUESTS / rps1, swap_to_q8)
    with s:
        timer.start()
        res = run_workload(s, stream, qps=rps1, seed=0)
        timer.join()
    require(swap.get("generation") == 1, f"serve_sched step 3: swap {swap}")
    k3 = gs.guided_score_chunk_q.launches - swap["k3_after"]
    q8_refs = per_request_refs(s, q8, params, stream, dev)
    gens = {0: 0, 1: 0}
    for i, h in enumerate(handles):
        resp = h.result()
        gens[resp.generation] += 1
        want = q8_refs[i] if resp.generation == 1 else sync[i]
        require(same_response(resp, want),
                f"serve_sched step 3: request {i} (generation "
                f"{resp.generation}, cached {h.cached}) differs from its "
                f"generation's per-request search")
        require(not (h.cached and h.t_submit > swap["done"]
                     and resp.generation != 1),
                f"serve_sched step 3: request {i} hit a pre-swap entry")
    st3 = s.stats()
    require(st3["cache_gen_evictions"] > 0 and gens[1] > 0 and k3 > 0,
            f"serve_sched step 3: evictions {st3['cache_gen_evictions']}, "
            f"generations {gens}, K3 launches after the swap {k3}")
    step3 = {"offered_qps": rps1, "swap_s": swap["seconds"],
             "generations": gens,
             "cache_gen_evictions": st3["cache_gen_evictions"],
             "cache_hits": st3["cache_hits"], "k3_launches": k3,
             **{k: res[k] for k in ("mrt_ms", "p50_ms", "p99_ms",
                                    "qps_achieved")},
             "check": "generation 1 == per-request q8 searches, generation "
                      "0 == step 1, no cache hit across generations"}
    emit("serve_sched", step="hot_swap", **step3)

    # -- step 4: one injected batch failure, retried; traced ------------------
    tracer = Tracer()
    s = scheduler(index, faults=FaultPlan([fail_batch(0)]),
                  retry=RetryPolicy(max_attempts=2), tracer=tracer)
    sub = stream[:SCHED_BURST]
    handles = [s.submit(r) for r in sub]
    s.flush()
    st4 = s.stats()
    require(st4["retries"] == 1 and st4["failed"] == 0
            and all(h.done() and h._exception is None for h in handles),
            f"serve_sched step 4: retries {st4['retries']}, failed "
            f"{st4['failed']}")
    require(all(same_response(h.result(), a)
                for h, a in zip(handles, sync)),
            "serve_sched step 4: responses differ from step 1")
    spans = tracer.export()
    requests = [sp for sp in spans if sp["name"] == "request"]
    executes = [sp for sp in spans if sp["name"] == "execute"]
    require(len(requests) == len(handles) == len(executes)
            and all("chunks_dispatched" in sp["attrs"] for sp in executes),
            f"serve_sched step 4: {len(requests)} request spans, "
            f"{len(executes)} execute spans for {len(handles)} requests")
    emit("serve_sched", step="retry", requests=len(handles),
         retries=st4["retries"], fired=[list(f) for f in s.faults.fired],
         request_spans=len(requests),
         chunks_dispatched_max=max(sp["attrs"]["chunks_dispatched"]
                                   for sp in executes),
         check="every handle completes, equal to step 1; one request span "
               "per request, each execute span with chunks_dispatched")
    emit("serve_sched", step="summary", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase,
         preset="original(gamma=0.2)",
         policy="table8_policy(long_engine='kernel', "
                "long_traversal='chunked_fused')",
         config=cfg, k_buckets=list(SCHED_KS),
         stream=f"mixed_request_stream(corpus, {SCHED_REQUESTS}, "
                f"short_len={SCHED_SHORT}, k_pool={SCHED_KS}, "
                f"query_pool={SCHED_POOL})",
         served_rps={"sync": rps1,
                     **{f"burst_{n}": step2[n]["burst"]["served_rps"]
                        for n in step2}})
    return {"guided_score_chunk": k1, "guided_score_chunk_q": k3}


# --------------------------------------------------------------------------
# sharded: tile-range shards on one card (emulation) and an NCCL group
# --------------------------------------------------------------------------

N_SHARDS = 4
SHARD_EXCHANGE = (0, 64)        # exchange periods of the rank-safe check
# the guided chunked path's exchange period: one chunk of 8 tiles (the
# default chunk_tiles) per round, so each shard's chunk loop stops against
# the global theta; exchange 0 is also run once, for its counters
GUIDED_EXCHANGE = 8


def shard_summary(sh, seconds: float) -> dict:
    """Host repack seconds, bytes on the card and the padding share of the
    stacked flat leaves of one partition."""
    nnz = sh.nnz_per_shard
    return {"repack_s": seconds, "device_bytes": sh.nbytes(),
            "tiles_per_shard": sh.tiles_per_shard,
            "nnz_per_shard": nnz.tolist(), "max_nnz": sh.max_nnz,
            "padding_share": 1.0 - float(nnz.sum())
            / (sh.n_shards * sh.max_nnz)}


def counted_search(fn, kernel):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (response, ms on the host clock, counts). Fails unless
    ``kernel`` launched, and it alone."""
    from repro_torch.kernels import guided_score as gs
    gs.reset_launches()
    t0 = time.perf_counter()
    resp = fn()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {f.__name__: f.launches for f in gs.KERNELS}
    require(counts[kernel] > 0 and sum(counts.values()) == counts[kernel],
            f"launches {counts}, expected {kernel} alone")
    return resp, ms, counts


def bit_equal(a, b, what: str, stats=()) -> None:
    require(np.array_equal(a.ids, b.ids)
            and np.array_equal(a.scores, b.scores)
            and all(np.array_equal(a.stats[k], b.stats[k]) for k in stats),
            f"sharded: {what} differ")


def split_stats(resp) -> dict:
    st = resp.stats
    out = {"tiles_visited": float(st["tiles_visited"].mean())}
    if "shard_tiles_visited" in st:
        out["shard_tiles_visited"] = st["shard_tiles_visited"].mean(
            0).tolist()
    if "chunks_dispatched" in st:
        out["chunks_dispatched"] = float(st["chunks_dispatched"].mean())
        out["n_chunks"] = float(st["n_chunks"][0])
    if "shard_chunks_dispatched" in st:
        out["shard_chunks_dispatched"] = st["shard_chunks_dispatched"].mean(
            0).tolist()
    return out


def phase_sharded(indexes, corpus, smi: str, dev) -> dict:
    """Sharded retrieval on the card: ``shard_index(index, 4)`` and
    ``shard_index(q8, 4)``, served through ``Retriever.open(...,
    engine="sharded", use_kernel=True)`` on one batch of 16 queries.
    Rank-safe (``original(gamma=0.2)``, full traversal, docid schedule,
    exchange every 0 and 64 tiles): ids and scores bit-equal to the
    single-device tile kernel's search at k=10 and k=100 (q8: at k=10).
    Guided (``fast()``, exchange every chunk): the chunked path bit-equal
    to the per-shard impact-ordered full scan (ids, scores, every stat),
    beside the single-device chunked path's counters and the chunked
    path without exchange; one profiled fp32 chunked batch. The
    collective path on an NCCL group of one rank equals the emulation on
    the q8 index at n_shards=1. Every
    sharded search is counted alone: K2 (K4 on q8) and nothing else.
    Returns the K2 and K4 launches of the sharded searches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import twolevel
    from repro_torch.core.shard_plan import shard_index
    from repro_torch.core.traversal import STAT_KEYS, retrieve_batched
    from repro_torch.retrieval import Retriever
    from repro_torch.serve import make_shard_mesh

    index, q8 = indexes["fp32"], indexes["q8"]
    t_phase = time.perf_counter()
    q = dict(terms=corpus.queries[:BATCH],
             weights_b=corpus.q_weights_b[:BATCH],
             weights_l=corpus.q_weights_l[:BATCH])
    qa = tuple(q.values())
    reduced = ["one batch of 16 queries per path and k",
               "guided and q8 paths at k=10 only (k=100 cut for the "
               "phase's time)", "the collective path on one rank"]
    parts, info = {}, {}
    for label, idx in (("fp32", index), ("q8", q8)):
        t0 = time.perf_counter()
        parts[label] = shard_index(idx, N_SHARDS, device=dev)
        torch.cuda.synchronize()
        info[label] = shard_summary(parts[label], time.perf_counter() - t0)
    emit("sharded", step="partition", n_shards=N_SHARDS, **info)

    tile = {"fp32": "guided_score_tile", "q8": "guided_score_tile_q"}
    launches = {name: 0 for name in tile.values()}
    ms = {}

    def sharded(label, params, k, what, **opts):
        r = Retriever.open(parts[label], params, engine="sharded",
                           use_kernel=True, device=dev, **opts)
        resp, t, counts = counted_search(lambda: r.search(**q, k=k),
                                         tile[label])
        launches[tile[label]] += counts[tile[label]]
        ms[f"{label} {what} k={k}"] = t
        return resp

    def single(label, params, k, what, traversal="full"):
        idx = index if label == "fp32" else q8
        t0 = time.perf_counter()
        resp = retrieve_batched(idx, *qa, params, use_kernel=True, k=k,
                                traversal=traversal)
        ms[f"{label} single-device {what} k={k}"] = (
            time.perf_counter() - t0) * 1e3
        return resp

    # first-call set-up outside the timings: one query through each
    for label in parts:
        Retriever.open(parts[label], twolevel.fast(), engine="sharded",
                       use_kernel=True, traversal="chunked",
                       device=dev).search(**{f: v[:1] for f, v in q.items()},
                                          k=KS[0])

    # -- rank-safe: bit-equal to the single-device tile kernel ----------------
    safe = twolevel.original(gamma=0.2)
    for label, ks in (("fp32", KS), ("q8", KS[:1])):
        for k in ks:
            ref = single(label, safe, k, "full docid")
            for every in SHARD_EXCHANGE:
                got = sharded(label, safe, k, f"full docid exchange "
                              f"{every}", exchange_every=every)
                bit_equal(got, ref, f"{label} rank-safe k={k} exchange "
                          f"{every} ids/scores vs single device")
    emit("sharded", step="rank_safe", preset="original(gamma=0.2)",
         traversal="full", schedule="docid", exchange_every=SHARD_EXCHANGE,
         check="ids and scores bit-equal to single-device "
               "retrieve_batched(use_kernel=True) at each k and exchange "
               "period (q8 at k=10)")

    # -- guided: chunked == the per-shard impact full scan --------------------
    fast = twolevel.fast()
    stat_keys = STAT_KEYS + ("n_tiles", "shard_tiles_visited")
    k = KS[0]
    guided = {}
    for label in parts:
        ck = sharded(label, fast, k, f"chunked exchange {GUIDED_EXCHANGE}",
                     traversal="chunked", exchange_every=GUIDED_EXCHANGE)
        full = sharded(label, fast.replace(schedule="impact"), k,
                       f"full impact exchange {GUIDED_EXCHANGE}",
                       exchange_every=GUIDED_EXCHANGE)
        bit_equal(ck, full, f"{label} guided k={k} chunked vs impact full "
                  f"scan", stat_keys)
        one = single(label, fast, k, "chunked", traversal="chunked")
        guided[label] = {"sharded_chunked": split_stats(ck),
                         "single_device_chunked": split_stats(one)}
    guided["fp32"]["sharded_chunked_exchange_0"] = split_stats(sharded(
        "fp32", fast, k, "chunked exchange 0", traversal="chunked"))
    emit("sharded", step="guided", preset="fast()", k=k,
         exchange_every=GUIDED_EXCHANGE, **guided,
         check="sharded chunked == per-shard impact full scan (ids, "
               "scores, every stat), bit for bit")

    # one profiled batch of the fp32 chunked path at k=10
    r = Retriever.open(parts["fp32"], fast, engine="sharded",
                       use_kernel=True, traversal="chunked",
                       exchange_every=GUIDED_EXCHANGE, device=dev)
    prof = profile_call(lambda: r.search(**q, k=k))
    emit("sharded", step="profile", path="fp32 chunked", k=k,
         exchange_every=GUIDED_EXCHANGE, **prof)

    # -- the collective path: an NCCL group of one rank -----------------------
    one = shard_index(q8, 1, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            tmp + "/store", 1), rank=0, world_size=1)
        try:
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            require(x.tolist() == [1.0] * 4, "sharded: NCCL all-reduce")
            got = {}
            for way, mesh in (("emulated", None), ("nccl",
                                                   make_shard_mesh(1))):
                r = Retriever.open(one, fast, engine="sharded",
                                   use_kernel=True, traversal="chunked",
                                   mesh=mesh, device=dev)
                got[way], t, counts = counted_search(
                    lambda: r.search(**q, k=k), tile["q8"])
                launches[tile["q8"]] += counts[tile["q8"]]
                ms[f"q8 1 shard chunked {way} k={k}"] = t
            bit_equal(got["nccl"], got["emulated"],
                      "the NCCL path and the emulation",
                      tuple(got["emulated"].stats))
        finally:
            dist.destroy_process_group()
    emit("sharded", step="distributed", backend="nccl", world_size=1,
         index="q8", check="one batch on make_shard_mesh(1) == the "
                           "emulation at n_shards=1 (ids, scores, every "
                           "stat)")

    for name, n in launches.items():
        require(n > 0, f"sharded: {name} never launched")
    emit("sharded", step="summary", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase, batch_ms=ms,
         launches=launches, reduced=reduced)
    return launches


# --------------------------------------------------------------------------
# hybrid: dense guided retrieval, the cascade / rrf engines and eval/
# --------------------------------------------------------------------------

HYBRID_BUDGET_S = 90.0
HYBRID_DEPTH = 100           # the hybrid engines' first-stage depth k'
# topk_scores_match's tolerance (tests/conftest.py)
SCORE_RTOL, SCORE_ATOL = 2e-5, 1e-4


def batches(n_queries: int):
    return [slice(i, i + BATCH) for i in range(0, n_queries, BATCH)]


def tied(scores) -> np.ndarray:
    """[k] positions of a descending score row (given k + 1 scores) whose
    gap to a neighbour lies within the score tolerance."""
    s = np.asarray(scores, np.float64)
    close = np.abs(np.diff(s)) <= SCORE_ATOL + SCORE_RTOL * np.abs(s[1:])
    out = np.zeros(len(s), bool)
    out[1:] |= close
    out[:-1] |= close
    return out[:-1]


def ids_off_ties(got_ids, want_ids, want_scores, what: str) -> int:
    """Require ``got_ids`` [B, k] == ``want_ids`` [B, k + 1] (cut to k)
    wherever the reference's scores [B, k + 1] are apart by more than the
    score tolerance; returns the positions compared."""
    checked = 0
    for g, w, s in zip(got_ids, want_ids, want_scores):
        free = ~tied(s)
        require(np.array_equal(g[free], w[:len(g)][free]),
                f"hybrid: {what}: ids differ off ties")
        checked += int(free.sum())
    return checked


def dense_build_ms(doc_emb, dev) -> dict:
    """The three steps of ``build_dense_index`` timed alone on the card
    (CUDA events, on the same embeddings): the covariance product, the
    eigendecomposition, the rotation with the block maxima and minima."""
    emb = torch.from_numpy(doc_emb).to(dev)
    n = emb.shape[0]
    cov = (emb.T @ emb) / n
    rot = torch.linalg.eigh(cov)[1].flip(1).contiguous()

    def rotate_and_blocks():
        blocks = (emb @ rot).view(-1, 4096, emb.shape[1])
        return blocks.amax(1), blocks.amin(1)
    out = {"covariance_ms": event_ms(lambda: (emb.T @ emb) / n, runs=5,
                                     warmup=1),
           "eigh_ms": event_ms(lambda: torch.linalg.eigh(cov), runs=5,
                               warmup=1),
           "rotate_and_blocks_ms": event_ms(rotate_and_blocks, runs=5,
                                            warmup=1)}
    del emb, cov, rot
    torch.cuda.empty_cache()
    return out


def phase_hybrid(graded, indexes, smi: str, dev) -> dict:
    """Dense guided retrieval and the hybrid engines on the card, at 2^20
    docs x 256-dim embeddings (the two-tower config's width).

    Indexes: ``build_hybrid(graded, sparse_index=index)`` (the fp32 BII
    already on the card, a dense side of 512-doc blocks), the same dense
    side over q8 (no second PCA), and ``build_dense_index`` at its
    defaults (4096-doc blocks, ``d_cheap`` 32) for the ``dense`` engine.
    Searches, 4 batches of 16 at k=10 and k=100 under ``original(gamma=
    0.2)`` and ``fast()``: ``cascade`` (k'=100, K1 ``chunked_fused``) on
    the fp32 hybrid, ``rrf`` (k'=100, K3) on the q8 one, and ``dense``
    rank-safe and guided on the raw query embeddings. Checks: cascade and
    rrf equal the first stage alone at k'=100 composed with
    ``rerank_candidates`` / ``dense_topk`` + ``rrf_fuse``; rerank scores
    within 1e-5 of float64 on the host; ``dense_topk`` and rank-safe
    ``dense`` ids equal a float64 host top-k / ``exhaustive_dense`` off
    ties; guided ``dense`` within the score tolerance of the same search
    on the index moved to the CPU (one batch at k=10); K1 / K3 alone
    launched. Then one ``evaluate_retriever`` row per lane (quality next
    to MRT), one profiled cascade batch and one profiled guided dense
    batch. Returns the K1 and K3 launches of the counted searches."""
    import dataclasses as dc

    from repro_torch.core import twolevel
    from repro_torch.core.dense_guided import (build_dense_index,
                                               exhaustive_dense)
    from repro_torch.eval import build_hybrid, evaluate_retriever
    from repro_torch.eval.synthetic import _embed_queries_np
    from repro_torch.kernels import guided_score as gs
    from repro_torch.retrieval import Retriever
    from repro_torch.retrieval.hybrid import (dense_topk, embed_queries,
                                              rerank_candidates, rrf_fuse)

    t_phase = time.perf_counter()
    index, q8 = indexes["fp32"], indexes["q8"]
    corpus = graded.corpus
    reduced = ["compositions and host float64 checks on the first batch "
               "of each (preset, k); one profiled batch per path",
               "guided dense against the CPU on one batch of 16 at k=10 "
               "(the CPU scan streams about 16 GB)"]
    # -- indexes ------------------------------------------------------------
    t0 = time.perf_counter()
    hybrid = build_hybrid(graded, tile_size=index.tile_size,
                          sparse_index=index, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hybrid_q8 = dc.replace(hybrid, sparse=q8)
    dense = build_dense_index(graded.doc_emb, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    require(hybrid.to(dev) is hybrid and hybrid_q8.dense is hybrid.dense,
            "hybrid: the q8 hybrid does not share the dense side")
    emit("hybrid", step="build", n_docs=hybrid.n_docs, dim=hybrid.dim,
         build_s={"hybrid_dense_side": t1 - t0, "dense_index": t2 - t1},
         dense_index_steps=dense_build_ms(graded.doc_emb, dev),
         nbytes={"hybrid": hybrid.nbytes(), "hybrid_q8": hybrid_q8.nbytes(),
                 "dense_index": dense.nbytes()},
         blocks={"hybrid": [hybrid.dense.block_size, hybrid.dense.n_blocks,
                            hybrid.dense.d_cheap],
                 "dense_index": [dense.block_size, dense.n_blocks,
                                 dense.d_cheap]})

    presets = {"original(gamma=0.2)": twolevel.original(gamma=0.2),
               "fast()": twolevel.fast()}
    rows_all = batches(len(corpus.queries))

    def sparse_q(rows):
        return dict(terms=corpus.queries[rows],
                    weights_b=corpus.q_weights_b[rows],
                    weights_l=corpus.q_weights_l[rows])
    first_opts = dict(first_stage="kernel", traversal="chunked_fused",
                      depth=HYBRID_DEPTH)
    lanes = {"cascade": (hybrid, "guided_score_chunk"),
             "rrf": (hybrid_q8, "guided_score_chunk_q")}
    launches = {kern: 0 for _, kern in lanes.values()}
    batch_ms, checks = {}, {}
    retr = {}
    for lane, (hyb, kern) in lanes.items():
        emb = hyb.dense.emb
        for pname, params in presets.items():
            r = Retriever.open(hyb, params, engine=lane, device=dev,
                               **first_opts)
            retr[lane, pname] = r
            first = Retriever.open(hyb.sparse, params, engine="kernel",
                                   traversal="chunked_fused", device=dev)
            r.search(**sparse_q(rows_all[0]), k=KS[0])   # first-call set-up
            for k in KS:
                resps, times = [], []
                for rows in rows_all:
                    resp, ms, n = counted_search(
                        lambda: r.search(**sparse_q(rows), k=k), kern)
                    launches[kern] += n[kern]
                    resps.append(resp)
                    times.append(ms)
                    require(resp.ids.shape == (BATCH, k)
                            and bool(np.isfinite(resp.scores).all())
                            and bool((np.diff(resp.scores, axis=1)
                                      <= 0).all()),
                            f"hybrid {lane} k={k}: malformed response")
                batch_ms[f"{lane} {pname} k={k}"] = times
                # the composition by hand, on the first batch
                q0 = sparse_q(rows_all[0])
                f = first.search(**q0, k=HYBRID_DEPTH)
                q_rot = embed_queries(hyb, q0["terms"], q0["weights_l"])
                got = resps[0]
                if lane == "cascade":
                    w_scores, w_ids = rerank_candidates(hyb, q_rot, f.ids, k)
                    live = got.ids >= 0
                    cand = torch.from_numpy(np.maximum(got.ids, 0)).long()
                    rows64 = emb[cand.to(dev)].double().cpu().numpy()
                    host = np.einsum("bkd,bd->bk", rows64,
                                     q_rot.double().cpu().numpy())
                    err = float(np.abs(host - got.scores)[live].max())
                    require(err <= 1e-5, f"hybrid: rerank scores {err} "
                                         f"from float64")
                    checks[f"cascade {pname} k={k}"] = {
                        "rerank_max_abs_err_vs_float64": err}
                else:
                    d_vals, d_ids = dense_topk(hyb, q_rot, HYBRID_DEPTH)
                    w_ids, w_scores = rrf_fuse(f.ids, d_ids, k)
                    if k == KS[-1] and pname == "fast()":
                        # dense_topk against a float64 host top-k
                        e64 = emb[:hyb.n_docs].double().cpu().numpy()
                        s64 = q_rot.double().cpu().numpy() @ e64.T
                        order = np.argsort(-s64, axis=1, kind="stable")
                        top = order[:, :HYBRID_DEPTH + 1]
                        want_s = np.take_along_axis(s64, top, 1)
                        checks["dense_topk vs float64"] = {
                            "positions_compared": ids_off_ties(
                                d_ids, top, want_s, "dense_topk"),
                            "max_abs_err": float(np.abs(
                                want_s[:, :HYBRID_DEPTH] - d_vals).max())}
                        require(checks["dense_topk vs float64"][
                            "max_abs_err"] <= 1e-5, "hybrid: dense_topk "
                                                    "scores off float64")
                        del e64, s64, order
                require(np.array_equal(got.ids, w_ids)
                        and np.array_equal(got.scores, w_scores),
                        f"hybrid: {lane} {pname} k={k} differs from the "
                        f"first stage composed by hand")
    emit("hybrid", step="cascade_rrf", depth=HYBRID_DEPTH,
         first_stage="kernel chunked_fused", lanes={
             "cascade": "fp32 hybrid, K1", "rrf": "q8 hybrid, K3"},
         batch_ms=batch_ms, launches=launches, checks=checks,
         check="ids and scores equal the first stage alone at k'=100 "
               "composed by hand (first batch); only the lane's kernel "
               "launched")

    # -- dense ---------------------------------------------------------------
    q_emb = _embed_queries_np(graded.q_proj, corpus.queries,
                              corpus.q_weights_l)
    dense_presets = {
        "rank_safe": twolevel.TwoLevelParams(alpha=0, beta=0, gamma=0),
        "guided": twolevel.TwoLevelParams(alpha=1, beta=0.3, gamma=0)}
    dense_ms, dense_stats = {}, {}
    for pname, params in dense_presets.items():
        r = Retriever.open(dense, params, engine="dense", device=dev)
        retr["dense", pname] = r
        r.search(dense=q_emb[rows_all[0]], k=KS[0])
        for k in KS:
            resps, times = [], []
            for rows in rows_all:
                gs.reset_launches()
                t0 = time.perf_counter()
                resp = r.search(dense=q_emb[rows], k=k)
                ms = (time.perf_counter() - t0) * 1e3
                require(all(f.launches == 0 for f in gs.KERNELS),
                        "hybrid: the dense path launched a guided kernel")
                resps.append(resp)
                times.append(ms)
            dense_ms[f"{pname} k={k}"] = times
            cfs = np.concatenate([x.stats["candidates_fully_scored"]
                                  for x in resps])
            dense_stats[f"{pname} k={k}"] = {
                "fully_scored_share": float(
                    cfs.mean() / resps[0].stats["n_candidates"])}
            if pname == "rank_safe":
                want = [exhaustive_dense(dense, q_emb[i], k + 1)
                        for i in range(len(q_emb))]
                w_s = np.stack([w[0] for w in want])
                w_i = np.stack([w[1] for w in want])
                got_s = np.concatenate([x.scores for x in resps])
                got_i = np.concatenate([x.ids for x in resps])
                np.testing.assert_allclose(got_s, w_s[:, :k],
                                           rtol=SCORE_RTOL, atol=SCORE_ATOL)
                dense_stats[f"{pname} k={k}"]["positions_compared"] = (
                    ids_off_ties(got_i, w_i, w_s, "rank-safe dense"))
                dense_stats[f"{pname} k={k}"]["ids_equal_share"] = float(
                    (got_i == w_i[:, :k]).mean())
    # guided on the card against the same search on the CPU
    r_gpu = retr["dense", "guided"]
    r_cpu = Retriever.open(dense.to("cpu"), dense_presets["guided"],
                           engine="dense", device="cpu")
    t0 = time.perf_counter()
    on_cpu = r_cpu.search(dense=q_emb[rows_all[0]], k=KS[0])
    cpu_s = time.perf_counter() - t0
    on_card = r_gpu.search(dense=q_emb[rows_all[0]], k=KS[0])
    np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    del r_cpu
    emit("hybrid", step="dense", block_size=dense.block_size,
         d_cheap=dense.d_cheap, n_blocks=dense.n_blocks,
         presets={p: dc.asdict(v) for p, v in dense_presets.items()},
         batch_ms=dense_ms, stats=dense_stats,
         guided_vs_cpu={"k": KS[0], "ids_equal_share": float(
             (on_card.ids == on_cpu.ids).mean()),
             "max_abs_err": float(np.abs(on_card.scores
                                         - on_cpu.scores).max()),
             "fully_scored_share_card": float(
                 on_card.stats["candidates_fully_scored"].mean()
                 / on_card.stats["n_candidates"]),
             "fully_scored_share_cpu": float(
                 on_cpu.stats["candidates_fully_scored"].mean()
                 / on_cpu.stats["n_candidates"]),
             "cpu_seconds": cpu_s},
         check="rank-safe ids == exhaustive_dense off ties, scores within "
               "rtol 2e-5 / atol 1e-4; guided within that of the CPU; no "
               "guided_score kernel launched")

    # -- quality next to latency, 64 judged queries in one batch ------------
    fast = twolevel.fast()
    sparse_r = Retriever.open(index, fast, engine="kernel",
                              traversal="chunked_fused", device=dev)
    quality = {}
    for lane, r, queries in (
            ("sparse K1", sparse_r, graded.queries()),
            ("cascade", retr["cascade", "fast()"], graded.queries()),
            ("rrf", retr["rrf", "fast()"], graded.queries()),
            ("dense guided", retr["dense", "guided"], {"dense": q_emb}),
            ("dense rank_safe", retr["dense", "rank_safe"],
             {"dense": q_emb})):
        row = evaluate_retriever(r, queries, graded.qrels, k=KS[-1])
        quality[lane] = {m: row[m] for m in (
            "mrr@10", "ndcg@10", "recall@10", "recall@100", "mrt_ms",
            "p99_ms", "n_queries")}
    emit("hybrid", step="quality", preset="fast() (dense: as named)",
         k=KS[-1], lanes=quality,
         note="one batch of all judged queries; mrt_ms = batch ms / "
              "queries, p99 over one timed call")

    # -- profile: one cascade batch at k=10 -----------------------------------
    r = retr["cascade", "fast()"]
    q0 = sparse_q(rows_all[0])
    prof = profile_call(lambda: r.search(**q0, k=KS[0]))
    first = Retriever.open(index, fast, engine="kernel",
                           traversal="chunked_fused", device=dev)
    first.search(**q0, k=HYBRID_DEPTH)          # first-call set-up
    t0 = time.perf_counter()
    first.search(**q0, k=HYBRID_DEPTH)
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r.search(**q0, k=KS[0])
    whole_ms = (time.perf_counter() - t0) * 1e3
    emit("hybrid", step="profile", path="cascade fast() k=10", **prof,
         first_stage_ms=first_ms, cascade_ms=whole_ms,
         first_stage_share=first_ms / whole_ms)
    r = retr["dense", "guided"]
    emit("hybrid", step="profile", path="dense guided k=10",
         **profile_call(lambda: r.search(dense=q_emb[rows_all[0]],
                                         k=KS[0])))

    seconds = time.perf_counter() - t_phase
    emit("hybrid", step="summary", nvidia_smi=smi, seconds=seconds,
         budget_s=HYBRID_BUDGET_S, within_budget=seconds <= HYBRID_BUDGET_S,
         launches=launches, reduced=reduced)
    return launches


# --------------------------------------------------------------------------
# stream_build: the streaming builder and the observability layer
# --------------------------------------------------------------------------

STREAM_CHUNK_DOCS = 2 ** 17


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_stream_build(corpus, q8, smi: str, dev) -> None:
    """The corpus streamed chunk by chunk through ``StreamingIndexBuilder``
    (spilled to a temporary directory) and finalized onto the card, held
    equal to ``q8`` (``compress_index`` of the same postings); then served
    through K3 and K4 with a metrics registry, bit-equal to the same
    searches on ``q8``. The streamed index is freed on return."""
    import tempfile

    from repro_torch.core import twolevel
    from repro_torch.core.traversal import TRACE_STAT_KEYS
    from repro_torch.data import StreamingIndexBuilder
    from repro_torch.index.compressed import SCALAR_FIELDS, TENSOR_FIELDS
    from repro_torch.kernels import guided_score as gs
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs import trace_exec
    from repro_torch.retrieval import Retriever

    add_s, n_chunks = [], 0
    with tempfile.TemporaryDirectory() as spill:
        builder = StreamingIndexBuilder(spill, n_terms=corpus.n_terms,
                                        tile_size=q8.tile_size,
                                        chunk_docs=STREAM_CHUNK_DOCS)
        t0 = time.perf_counter()
        for chunk in corpus.iter_chunks(STREAM_CHUNK_DOCS):
            t1 = time.perf_counter()
            require(builder.add_chunk(chunk), f"chunk {chunk.chunk_id} "
                                              f"already recorded")
            add_s.append(time.perf_counter() - t1)
            n_chunks += 1
        stream_s = time.perf_counter() - t0
        spill_bytes = dir_bytes(spill)
        t0 = time.perf_counter()
        streamed = builder.finalize()
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t0
    require(streamed.device == q8.device,
            f"finalize: index on {streamed.device}, not {q8.device}")
    for f in SCALAR_FIELDS:
        require(getattr(streamed, f) == getattr(q8, f),
                f"streamed {f} {getattr(streamed, f)} != {getattr(q8, f)}")
    for f in TENSOR_FIELDS:
        require(torch.equal(getattr(streamed, f), getattr(q8, f)),
                f"streamed {f} differs from compress_index's")
    require(streamed.orig_of_new is None and q8.orig_of_new is None,
            "streamed index: unexpected doc reordering")

    fast = twolevel.fast()
    paths = {}
    for name, traversal in PATHS["q8"]:
        # the same searches on the compress_index index first (which also
        # warms the path), then the streamed index's: the main path's run
        counts, resps, registry = {}, {}, MetricsRegistry()
        for label, index, metrics in (("compress_index", q8, None),
                                      ("streamed", streamed, registry)):
            r = Retriever.open(index, fast, engine="kernel",
                               traversal=traversal, device=dev,
                               metrics=metrics)
            gs.reset_launches()
            resps[label] = {k: run_batches(r, corpus, k) for k in KS}
            counts[label] = {fn.__name__: fn.launches for fn in gs.KERNELS}
        require(counts["streamed"][name] > 0, f"stream_build: {name} never "
                                              f"launched")
        require(counts["streamed"] == counts["compress_index"],
                f"stream_build {name}: launches {counts['streamed']} vs "
                f"{counts['compress_index']} on the compress_index index")
        for k in KS:
            for a, b in zip(resps["streamed"][k], resps["compress_index"][k]):
                require(np.array_equal(a.ids, b.ids), f"{name} k={k}: ids")
                require(a.scores.tobytes() == b.scores.tobytes(),
                        f"{name} k={k}: scores not bit-equal")
                require(set(a.stats) == set(b.stats), f"{name}: stat keys")
                for key in a.stats:
                    require(np.asarray(a.stats[key]).tobytes()
                            == np.asarray(b.stats[key]).tobytes(),
                            f"{name} k={k}: stat {key} differs")
        hist = registry.histogram("search_ms/kernel")
        n_searches = N_BATCHES * len(KS)
        require(hist.n == n_searches, f"{name}: search_ms/kernel holds "
                                      f"{hist.n} samples, {n_searches} "
                                      f"searches ran")
        paths[name] = {
            "traversal": traversal, "launches": counts["streamed"],
            "search_ms": {"count": hist.n, "p50_ms": hist.quantile(0.5),
                          "p99_ms": hist.quantile(0.99),
                          "summary": hist.summary()},
            **{f"k{k}": [{"batch_ms": r.latency_ms,
                          **trace_exec.request_attributes(r.stats)}
                         for r in resps["streamed"][k]] for k in KS}}
    emit("stream_build", n_docs=streamed.n_docs, chunk_docs=STREAM_CHUNK_DOCS,
         chunks=n_chunks, tile_size=streamed.tile_size,
         add_chunk_seconds={"sum": sum(add_s), "per_chunk": add_s},
         stream_seconds=stream_s, finalize_seconds=finalize_s,
         spill_bytes=spill_bytes, device_bytes=streamed.nbytes(),
         equal_to_compress_index="every tensor field, n_docs, n_tiles, nnz, "
                                 "pad_len",
         serve=paths, serve_check="ids, scores, every stat and launch "
                                  "counts bit-equal to compress_index's",
         trace_stat_keys=list(TRACE_STAT_KEYS), nvidia_smi=smi)


# --------------------------------------------------------------------------
# models: the LM and recsys serve steps (flash_attention, embedding_bag)
# --------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense, tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 dense, tensor cores
TF32_PASSES = 3                # TF32 products per float32 product on "f32"
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "granite-3-2b", 4, 4096, 32
LM_MAX_LEN = LM_PROMPT + LM_DECODE
RECSYS_ARCHS = ("dlrm-rm2", "two-tower-retrieval", "bert4rec")
RECSYS_CHECK_ROWS, RECSYS_CHECK_CANDS = 8, 65536
# K6 against its plain version, per element: ``fa.tolerance`` of the
# call's route (float32, the "f32" route, 2e-4 + 2e-4 |plain|; bfloat16
# 1e-2 |plain| + (2^-8 + 1e-4) (p @ |v|) on "mma" and "split", which round
# P to bfloat16). The outputs of a long average are small, so a fixed floor
# would pass a zeroed output; each main-path check also shows that a
# zeroed output and one without the last key tile fail. K5: bit-equal.
FA_TILE_KEYS = 64               # keys per tile of the without-last-tile check
FA_TOLERANCE = ("float32 (f32) within 2e-4 + 2e-4|plain|; bfloat16 (mma, "
                "split) within 1e-2|plain| + (2^-8 + 1e-4) (p @ |v|)")
# The decode path against a cache-free forward, and bfloat16 models on
# the card against the CPU: max |d| <= 2% of max |reference| (bfloat16
# keeps about 3 significant digits, and the two paths round their matrix
# products at other places, through every layer; runs of this script
# measured 1.0% and 0.6%).
BF16_MODEL_RTOL = 0.02
# Decode against the cache-free forward, argmax: with max |d| = e, the
# token decode picks has a reference logit within 2 e of the reference's
# top, so argmax must agree only where the reference's top-2 margin
# exceeds 2 e; at least this many of the 32 positions must be such.
LM_STRICT_MIN = 8
# The float32 model (every K6 call on "f32"): decode against the
# cache-free forward within 1e-3 of max |ref| (float32 throughout, TF32
# off; the two paths only sum in other orders).
LM_F32_PROMPT, LM_F32_DECODE, F32_MODEL_RTOL = 128, 8, 1e-3


def model_kernels():
    """The model path's kernel modules, by kernel name."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa, "embedding_bag": eb}


def fa_routes(**counts) -> dict:
    """K6 launches by route: ``counts`` on the routes named, 0 on the
    others ``flash_attention.route`` can return."""
    from repro_torch.kernels import flash_attention as fa
    return {way: counts.get(way, 0) for way in fa.ROUTES}


def reset_model_launches() -> None:
    for mod in model_kernels().values():
        mod.reset_launches()


def model_launches() -> dict:
    """Launches per kernel since the last reset; K6 also by route."""
    from repro_torch.kernels import flash_attention as fa
    counts = {name: mod.launches for name, mod in model_kernels().items()}
    counts["flash_attention_routes"] = dict(fa.launches_by_route)
    return counts


@contextlib.contextmanager
def first_call(module, name):
    """Record the arguments of the first call of ``module.name`` (the
    callers look the function up on the module at each call); the list
    holds (args, kwargs) once it was called."""
    real = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return real(*args, **kwargs)
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def synced_ms(fn) -> tuple:
    """(result, host ms) of ``fn()`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fa_bound(q, k, causal, kv_offset) -> dict:
    """K6: q and out, and the K/V rows some query sees, moved once; 4 D
    operations per visible (query, key) pair, at the tensor-core rate of
    bfloat16 (float32: three times as many at the TF32 tensor-core rate,
    as the "f32" route forms each product from three TF32 products)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    elt = q.element_size()
    pos = kv_offset + torch.arange(sq)
    visible = (torch.clamp(pos + 1, max=skv) if causal
               else torch.full((sq,), skv))
    n_keys = int(visible.max()) if sq else 0
    nbytes = elt * (2 * b * h * sq * d + 2 * b * hkv * n_keys * d)
    ops = 4 * d * b * h * int(visible.sum())
    if q.dtype == torch.bfloat16:
        t_ops = ops / BF16_OPS_PER_S * 1e3
    else:
        ops *= TF32_PASSES
        t_ops = ops / TF32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "shape": {
                "q": list(q.shape), "k": list(k.shape), "causal": causal,
                "kv_offset": kv_offset, "dtype": str(q.dtype)}}


def eb_bound(table, idx) -> dict:
    """K5: the distinct gathered rows, the indices and weights read once,
    the output written once; 2 float operations per gathered element."""
    tab = table if table.dim() == 3 else table[None]
    ix = idx if idx.dim() == 3 else idx[:, None]
    n_fields, vocab, d = tab.shape
    elt = tab.element_size()
    field = torch.arange(n_fields, device=ix.device)[None, :, None]
    rows = int(torch.unique((field * vocab + ix.long()).flatten()).numel())
    slots = ix.numel()
    nbytes = rows * d * elt + slots * (4 + elt) + ix.shape[0] * n_fields * d * elt
    ops = 2 * slots * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "distinct_rows": rows,
            "shape": {"table": list(tab.shape), "idx": list(ix.shape),
                      "dtype": str(tab.dtype)}}


def by_sequence(fn, q, k, v, split: bool):
    """``fn(q, k, v)``, one sequence at a time where ``split`` (the plain
    version's float32 scores of all sequences would not fit beside the
    model)."""
    if not split:
        return fn(q, k, v)
    return torch.cat([fn(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                      for i in range(q.shape[0])])


def fa_tolerance(q, k, v, ref, kwargs, split: bool = False):
    """K6's per-element bound against its plain output ``ref``:
    ``fa.tolerance`` of the route these inputs take, one sequence at a
    time where ``split``."""
    from repro_torch.kernels import flash_attention as fa
    way = fa.route(q, k)
    if not split:
        return fa.tolerance(q, k, v, ref, way, **kwargs)
    return torch.cat([fa.tolerance(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   ref[i:i + 1], way, **kwargs)
                      for i in range(q.shape[0])])


def outside_share(out, ref, tol) -> float:
    """The share of elements of ``out`` beyond ``tol`` of ``ref``."""
    return float(((out.float() - ref.float()).abs() > tol).float().mean())


def fa_close(name, out, ref, tol) -> float:
    """K6 against its plain version within ``tol``; returns max |d|."""
    require(out.shape == ref.shape and out.dtype == ref.dtype,
            f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} "
            f"{ref.dtype}")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    require(bool((diff <= tol).all()),
            f"{name}: max|d| {diff.max().item()}, "
            f"{outside_share(out, ref, tol)} of it beyond tolerance")
    return diff.max().item()


def attention_kept(q, k, v, keep, sm_scale=None):
    """Plain attention of q [B, H, Sq, D] over the keys ``keep`` [Sq, Skv]
    marks (GQA as K6), float32 inside, cast to q's dtype."""
    group = q.shape[1] // k.shape[1]
    scale = sm_scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(group, 1)) * scale
    p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float().repeat_interleave(
        group, 1)).to(q.dtype)


def tf32(x):
    """float32 rounded to TF32 as ``cvt.rna`` rounds it: to nearest, ties
    away from zero, the low 13 bits of the pattern cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def attention_one_tf32_pass(q, k, v, causal, kv_offset, sm_scale=None):
    """K6 in float32 with one TF32 pass per product (the arithmetic the
    "f32" route must not have): Q, K, P and V rounded to TF32, each
    product of the rounded operands exact and summed in float32 (TF32 is
    off for float32 matrix products here), l from the unrounded P."""
    group = q.shape[1] // k.shape[1]
    scale = sm_scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", tf32(q),
                     tf32(k).repeat_interleave(group, 1)) * scale
    if causal:
        pos = kv_offset + torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(torch.arange(k.shape[2], device=q.device)[None]
                          > pos[:, None], -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", tf32(p),
                       tf32(v).repeat_interleave(group, 1))
    return out / p.sum(-1, keepdim=True)


def without_last_tile(sq, skv, causal, kv_offset, device):
    """[Sq, Skv]: the keys each row sees, less the FA_TILE_KEYS tile that
    holds its last one (a row of one tile keeps it): what a kernel that
    skipped its last tile would read."""
    pos = kv_offset + torch.arange(sq, device=device)
    last = (torch.clamp(pos, max=skv - 1) if causal
            else torch.full_like(pos, skv - 1))
    start = last // FA_TILE_KEYS * FA_TILE_KEYS
    cut = torch.where(start > 0, start, last + 1)
    return torch.arange(skv, device=device)[None, :] < cut[:, None]


def sdpa_call(q, k, v, causal, kv_offset):
    """One ``scaled_dot_product_attention`` call computing K6's function
    (the yardstick; the port never calls it), or None where this PyTorch
    has no ``enable_gqa``."""
    import torch.nn.functional as F
    if "enable_gqa" not in (F.scaled_dot_product_attention.__doc__ or ""):
        return None
    kw = {"enable_gqa": k.shape[1] != q.shape[1]}
    if causal and kv_offset == 0 and q.shape[2] <= k.shape[2]:
        kw["is_causal"] = True          # top-left aligned: row i sees 0..i
    elif causal:
        pos = kv_offset + torch.arange(q.shape[2], device=q.device)
        kw["attn_mask"] = pos[:, None] >= torch.arange(k.shape[2],
                                                       device=q.device)
    return functools.partial(F.scaled_dot_product_attention, q, k, v, **kw)


def measure_fa(args, kwargs, per_sequence_plain: bool) -> dict:
    """K6 on main-path inputs: checked against its plain version (one
    sequence at a time where the plain version's float32 scores of all
    sequences would not fit beside the model), timed beside its bound,
    the plain version and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    # held to the plain version that keeps P in float32, which
    # ``fa.tolerance`` is derived against (the model's ``round_p`` asks the
    # CPU path for the reference model's rounding; the card ignores it)
    kwargs = {key: val for key, val in kwargs.items() if key != "round_p"}
    causal, off = kwargs.get("causal", True), kwargs.get("kv_offset", 0)
    split = per_sequence_plain
    kern = functools.partial(fa.flash_attention, q, k, v, **kwargs)
    plain = functools.partial(by_sequence, functools.partial(
        fa.flash_attention_plain, **kwargs), q, k, v, split)
    ref = plain()
    tol = fa_tolerance(q, k, v, ref, kwargs, split)
    way = fa.route(q, k)
    out = kern()
    err = fa_close("flash_attention main", out, ref, tol)
    # the bound rejects a zeroed output and one without each row's last
    # key tile, on these inputs
    keep = without_last_tile(q.shape[2], k.shape[2], causal, off, q.device)
    rejected = {}
    for name, wrong in (("zeroed", lambda: torch.zeros_like(ref)),
                        ("without_last_key_tile", lambda: by_sequence(
                            functools.partial(attention_kept, keep=keep,
                                              sm_scale=kwargs.get(
                                                  "sm_scale")),
                            q, k, v, split))):
        rejected[name] = outside_share(wrong(), ref, tol)
        require(rejected[name] > 0, f"flash_attention main: a {name} "
                                    f"output passes the tolerance")
    passes = {}
    if way == "f32":
        # the kernel within the tighter bound of its pass structure, where
        # one TF32 pass per product (emulated here) falls outside it
        tight = fa.three_pass_bound(ref)
        fa_close("flash_attention main, three TF32 passes", out, ref, tight)
        one = attention_one_tf32_pass(q, k, v, causal, off,
                                      kwargs.get("sm_scale"))
        rejected["one_tf32_pass"] = outside_share(one, ref, tight)
        require(rejected["one_tf32_pass"] > 0,
                "flash_attention main: one TF32 pass per product passes "
                "fa.three_pass_bound")
        passes = {"three_pass_bound": "2e-5 + 2e-5 |plain|",
                  "max_err_over_three_pass_bound": float(
                      ((out - ref).abs() / tight).max()),
                  "one_tf32_pass_max_err_over_tolerance": float(
                      ((one - ref).abs() / tol).max()),
                  "one_tf32_pass_outside_tolerance": outside_share(
                      one, ref, tol)}
        del one, tight
    del ref, tol, keep, out
    lib = sdpa_call(q, k, v, causal, off)
    t_k, t_p = timings(kern), timings(plain)
    return {"route": way, "max_abs_err": err,
            "wrong_outputs_rejected": rejected, **passes, **t_k,
            "plain_ms": t_p["ms"], "plain_event_ms": t_p["event_ms"],
            "library_ms": None if lib is None else timings(lib)["ms"],
            "library": "scaled_dot_product_attention(enable_gqa)",
            **fa_bound(q, k, causal, off)}


def rotating_fa(q, layers, kwargs) -> dict:
    """K6 at decode on inputs that rotate over every layer's cache
    (``layers``: one (k, v) view per layer; 1.35 GB at the LM's decode
    shape, far past the 50 MB L2), so each call reads its K/V from device
    memory as a decode step does: the route's kernel (uncounted) and SDPA,
    each timed over one pass through all layers."""
    from repro_torch.kernels import flash_attention as fa
    causal, off = kwargs.get("causal", True), kwargs.get("kv_offset", 0)
    scale = kwargs.get("sm_scale") or q.shape[-1] ** -0.5
    way = fa.route(q, layers[0][0])
    out = torch.empty_like(q)

    def rotate(calls):
        it = itertools.cycle(calls)
        return lambda: next(it)()

    ms = {"ms": device_ms(rotate([functools.partial(
        fa._launch, way, q, k, v, out, causal, scale, off)
        for k, v in layers]), _cycles_per_ms(), runs=len(layers))["ms"]}
    lib = [sdpa_call(q, k, v, causal, off) for k, v in layers]
    ms["library_ms"] = (None if lib[0] is None else device_ms(
        rotate(lib), _cycles_per_ms(), runs=len(layers))["ms"])
    bound = fa_bound(q, layers[0][0], causal, off)
    return {"route": way, "layers": len(layers),
            "bytes_all_layers": bound["bytes"] * len(layers), **ms,
            "bound_ms": bound["bound_ms"],
            "timing": "events, back to back behind a spin kernel, one pass "
                      "over the layers' caches"}


def measure_eb(args) -> dict:
    """K5 on main-path inputs: bit-equal to its plain version, timed beside
    its bound, the plain version and one F.embedding_bag call over the
    flattened tables."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    table, idx, w = args
    out = eb.embedding_bag(table, idx, w)
    require(torch.equal(out, eb.embedding_bag_plain(table, idx, w)),
            "embedding_bag main: differs from its plain version")
    tab, ix, _, _ = eb._fields(table, idx, w)
    off = (torch.arange(tab.shape[0], device=ix.device) * tab.shape[1])
    flat_idx = (ix.long() + off[None, :, None]).reshape(-1, ix.shape[-1])
    flat_w = w.reshape(-1, ix.shape[-1])
    flat_tab = tab.reshape(-1, tab.shape[-1])
    t_k = timings(functools.partial(eb.embedding_bag, table, idx, w))
    t_p = timings(functools.partial(eb.embedding_bag_plain, table, idx, w))
    t_l = timings(lambda: F.embedding_bag(flat_idx, flat_tab, mode="sum",
                                          per_sample_weights=flat_w))
    return {"max_abs_err": 0.0, **t_k, "plain_ms": t_p["ms"],
            "plain_event_ms": t_p["event_ms"], "library_ms": t_l["ms"],
            "library": "F.embedding_bag(mode=sum, per_sample_weights)",
            **eb_bound(table, idx)}


def check_argmax(got, ref, diff: float) -> dict:
    """Decode logits ``got`` against the cache-free reference ``ref`` [B,
    N, V] whose max |d| is ``diff``. Where the reference's top-2 margin
    exceeds 2 diff, the bound fixes the argmax: it must agree. Elsewhere
    the bound only places decode's pick within 2 diff of the reference's
    top logit (reported as ``max_pick_gap``), and a near-tie may flip with
    any change of rounding. At least LM_STRICT_MIN positions must fall
    under the strict rule, so the check cannot turn empty."""
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    strict = margin > 2 * diff
    pick = got.argmax(-1)
    same = pick == ref.argmax(-1)
    pick_gap = top2[..., 0] - ref.gather(-1, pick[..., None])[..., 0]
    out = {"positions": int(margin.numel()),
           "strict": {"positions": int(strict.sum()),
                      "argmax_agree": int((same & strict).sum())},
           "near_tie": {"positions": int((~strict).sum()),
                        "argmax_agree": int((same & ~strict).sum()),
                        "max_pick_gap": float(pick_gap[~strict].max())
                        if bool((~strict).any()) else 0.0},
           "min_top2_margin": float(margin.min())}
    require(out["strict"]["positions"] >= LM_STRICT_MIN,
            f"decode vs cache-free forward: only "
            f"{out['strict']['positions']} positions have a top-2 margin "
            f"above 2 max|d| = {2 * diff}")
    require(bool(same[strict].all()), f"decode vs cache-free forward: "
                                      f"argmax differs at a strict position "
                                      f"({out})")
    return {"argmax": out}


def phase_lm(seed: int, dev) -> dict:
    """granite-3-2b at full width: prefill 4 x 4096 prompts into a 4128
    cache, 32 greedy decode steps, the last 8 against a cache-free forward,
    K6 checked and timed on the layer-0 inputs of both (decode also on
    inputs rotating over every layer's cache), a profile of each; then
    the float32 path (``phase_lm_f32``). Returns the launch counts and
    K6's main-path measurements."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    arch = get_arch(LM_ARCH)
    cfg = arch.config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    master = steps.init_fn(arch, "prefill_32k", cfg, device=dev)(seed)
    params = T.compute_params(cfg, master)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    prefill = steps.make_serve_step(arch, "prefill_32k", cfg,
                                    max_len=LM_MAX_LEN)
    decode = steps.make_serve_step(arch, "decode_32k", cfg)

    with first_call(fa, "flash_attention") as seen:      # warm-up run
        logits, cache = prefill(params, tokens)
    pre_args = seen[0]
    del logits, cache
    reset_model_launches()
    (logits, cache), prefill_ms = synced_ms(lambda: prefill(params, tokens))
    launches = {"prefill": model_launches()}
    require(launches["prefill"]["flash_attention_routes"] == fa_routes(
        mma=cfg.n_layers),
        f"prefill: K6 launches by route "
        f"{launches['prefill']['flash_attention_routes']}, expected "
        f"{cfg.n_layers} on mma")
    require(bool(torch.isfinite(logits).all()), "prefill: non-finite logits")
    cache_bytes = tree_bytes(cache)

    gen = [logits[:, -1].argmax(-1)[:, None]]
    dec_logits = []
    dec_args = None
    reset_model_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        if i == 1:
            with first_call(fa, "flash_attention") as seen:
                lg, cache = decode(params, gen[-1], cache, LM_PROMPT + i)
            dec_args = seen[0]
        else:
            lg, cache = decode(params, gen[-1], cache, LM_PROMPT + i)
        dec_logits.append(lg[:, 0])
        gen.append(lg[:, -1].argmax(-1)[:, None])
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
    launches["decode"] = model_launches()
    require(launches["decode"]["flash_attention_routes"] == fa_routes(
        split=cfg.n_layers * LM_DECODE),
        f"decode: K6 launches by route "
        f"{launches['decode']['flash_attention_routes']}, expected "
        f"{cfg.n_layers} per step on split")
    dec = torch.stack(dec_logits, 1)                 # [B, 32, V]
    require(bool(torch.isfinite(dec).all()), "decode: non-finite logits")
    peak = torch.cuda.max_memory_allocated()

    # the last 8 decode steps against a cache-free forward over the prompt
    # and the generated tokens (position LM_PROMPT + i holds gen[i])
    seq = torch.cat([tokens] + [g.to(tokens.dtype) for g in gen[:-1]], 1)
    reset_model_launches()
    hidden, _, _ = T.forward(cfg, params, seq)
    ref_launches = model_launches()      # a check, not the main path
    require(ref_launches["flash_attention_routes"] == fa_routes(
        mma=cfg.n_layers),
        f"cache-free forward: K6 launches "
        f"by route {ref_launches['flash_attention_routes']}")
    ref = T.logits_fn(cfg, params, hidden[:, LM_PROMPT + LM_DECODE - 8:])
    got = dec[:, LM_DECODE - 8:]
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(diff <= BF16_MODEL_RTOL * scale,
            f"decode vs cache-free forward: max|d| {diff} > "
            f"{BF16_MODEL_RTOL} * {scale}")
    argmax = check_argmax(got, ref[..., :cfg.vocab], diff)
    del hidden, ref

    prof = {"prefill": profile_call(lambda: prefill(params, tokens),
                                    warm=False),
            "decode_step": profile_call(lambda: decode(
                params, gen[-1], cache, LM_MAX_LEN - 1), warm=False)}
    main = {"prefill": measure_fa(*pre_args, per_sequence_plain=True),
            "decode": measure_fa(*dec_args, per_sequence_plain=False)}
    main["decode"]["rotating"] = rotating_fa(
        dec_args[0][0], [tuple(cache[key][i].transpose(1, 2)
                               for key in ("k", "v"))
                         for i in range(cfg.n_layers)], dec_args[1])
    emit("lm", arch=LM_ARCH, source=arch.source,
         config={"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                 "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "compute_dtype": str(cfg.compute_dtype),
                 "param_dtype": str(cfg.param_dtype)},
         params=cfg.param_count(), init_seconds=init_s,
         device_bytes={"params_master": tree_bytes(master),
                       "params_compute": tree_bytes(params),
                       "kv_cache": cache_bytes, "peak": peak},
         prefill={"batch": LM_BATCH, "prompt": LM_PROMPT,
                  "max_len": LM_MAX_LEN, "ms": prefill_ms,
                  "tokens_per_s": LM_BATCH * LM_PROMPT / prefill_ms * 1e3},
         decode={"steps": LM_DECODE, "ms_per_step": decode_ms,
                 "tokens_per_s": LM_BATCH / decode_ms * 1e3},
         launches=launches,
         flash_attention_per_forward=launches["prefill"]["flash_attention"],
         check={"decode_vs_cache_free_forward": {
             "steps": 8, "max_abs_diff": diff, "max_abs_logit": scale,
             "launches": ref_launches, **argmax,
             "tolerance": f"max|d| <= {BF16_MODEL_RTOL} * max|ref|; argmax "
                          f"identical where the reference's top-2 margin > "
                          f"2 max|d| (at least {LM_STRICT_MIN} positions)"}},
         profile=prof,
         kernel_check={k: {f: v[f] for f in (
             "route", "max_abs_err", "wrong_outputs_rejected",
             "max_err_over_three_pass_bound",
             "one_tf32_pass_max_err_over_tolerance",
             "one_tf32_pass_outside_tolerance", "shape") if f in v}
                       for k, v in main.items()},
         decode_rotating=main["decode"]["rotating"],
         reduced=["prefill_32k: batch 32 x 32768 -> 4 x 4096 (time limit)",
                  "decode_32k: batch 128 x 32768 cache -> 4 x 4128 (one "
                  "card's memory)", "long_500k not run"])
    del params, cache, pre_args, dec_args
    f32 = phase_lm_f32(arch, cfg, master, seed)
    del master
    launches.update(f32["launches"])
    main.update(f32["main"])
    return {"launches": launches, "main": main}


def phase_lm_f32(arch, cfg, master, seed: int) -> dict:
    """The LM at full width in float32 compute, the path of K6's "f32"
    route: prefill 4 x 128 prompts into a 136-position cache, 8 greedy
    decode steps against a cache-free forward, K6 checked and timed on the
    layer-0 inputs of the prefill and of a decode step. Returns the launch
    counts and K6's measurements."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    params = T.compute_params(cfg, master)        # the master's tensors
    max_len = LM_F32_PROMPT + LM_F32_DECODE
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        1, cfg.vocab, (LM_BATCH, LM_F32_PROMPT)).astype(np.int32)).to(
        master["embed"].device)
    prefill = steps.make_serve_step(arch, "prefill_32k", cfg,
                                    max_len=max_len)
    decode = steps.make_serve_step(arch, "decode_32k", cfg)
    with first_call(fa, "flash_attention") as seen:      # warm-up run
        prefill(params, tokens)
    pre_args = seen[0]
    reset_model_launches()
    (logits, cache), prefill_ms = synced_ms(lambda: prefill(params, tokens))
    launches = {"prefill_f32": model_launches()}
    gen = [logits[:, -1].argmax(-1)[:, None]]
    dec_logits = []
    reset_model_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_F32_DECODE):
        if i == 1:
            with first_call(fa, "flash_attention") as seen:
                lg, cache = decode(params, gen[-1], cache, LM_F32_PROMPT + i)
            dec_args = seen[0]
        else:
            lg, cache = decode(params, gen[-1], cache, LM_F32_PROMPT + i)
        dec_logits.append(lg[:, 0])
        gen.append(lg[:, -1].argmax(-1)[:, None])
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_F32_DECODE
    launches["decode_f32"] = model_launches()
    for name, n in (("prefill_f32", cfg.n_layers),
                    ("decode_f32", cfg.n_layers * LM_F32_DECODE)):
        require(launches[name]["flash_attention_routes"] == fa_routes(f32=n),
                f"{name}: K6 launches by route "
                f"{launches[name]['flash_attention_routes']}, expected {n} "
                f"on f32")
    got = torch.stack(dec_logits, 1)                 # [B, 8, V]
    require(bool(torch.isfinite(got).all()), "lm_f32: non-finite logits")
    seq = torch.cat([tokens] + [g.to(tokens.dtype) for g in gen[:-1]], 1)
    hidden, _, _ = T.forward(cfg, params, seq)
    ref = T.logits_fn(cfg, params, hidden[:, LM_F32_PROMPT:])
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(diff <= F32_MODEL_RTOL * scale,
            f"lm_f32 decode vs cache-free forward: max|d| {diff} > "
            f"{F32_MODEL_RTOL} * {scale}")
    argmax = check_argmax(got, ref[..., :cfg.vocab], diff)
    del hidden, ref
    main = {"prefill_f32": measure_fa(*pre_args, per_sequence_plain=False),
            "decode_f32": measure_fa(*dec_args, per_sequence_plain=False)}
    emit("lm_f32", arch=LM_ARCH, compute_dtype=str(cfg.compute_dtype),
         prefill={"batch": LM_BATCH, "prompt": LM_F32_PROMPT,
                  "max_len": max_len, "ms": prefill_ms},
         decode={"steps": LM_F32_DECODE, "ms_per_step": decode_ms},
         launches=launches,
         check={"decode_vs_cache_free_forward": {
             "steps": LM_F32_DECODE, "max_abs_diff": diff,
             "max_abs_logit": scale, **argmax,
             "tolerance": f"max|d| <= {F32_MODEL_RTOL} * max|ref|"}},
         kernel_check={k: {f: v[f] for f in (
             "route", "max_abs_err", "wrong_outputs_rejected",
             "max_err_over_three_pass_bound",
             "one_tf32_pass_max_err_over_tolerance",
             "one_tf32_pass_outside_tolerance", "shape") if f in v}
                       for k, v in main.items()},
         reduced=[f"float32 compute, prompt {LM_BATCH} x {LM_F32_PROMPT} and "
                  f"{LM_F32_DECODE} decode steps: the path of the f32 "
                  f"route, not a serving cell"])
    del params, cache, pre_args, dec_args
    return {"launches": launches, "main": main}


def cell_inputs(arch, shape, cfg, seed, dev) -> dict:
    """A recsys cell's inputs at its full size (RECSYS_SHAPE_DEFS): ids
    drawn by numpy from ``seed``, float arrays by a generator on the
    card."""
    from repro_torch.configs import RECSYS_SHAPE_DEFS
    from repro_torch.models import recsys as R
    d = RECSYS_SHAPE_DEFS[shape]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ids(hi, size, lo=0):
        return torch.from_numpy(rng.integers(lo, hi, size).astype(
            np.int32)).to(dev)
    b = d["batch"]
    n = d["n_cand"] if d["kind"] == "retrieval" else d["shortlist"]
    if isinstance(cfg, R.DLRMConfig):
        dense = torch.randn(b, cfg.n_dense, generator=gen, device=dev)
        if d["kind"] == "serve":
            return {"batch": {"dense": dense, "sparse": ids(
                cfg.vocab_per_field, (b, cfg.n_sparse, cfg.multi_hot))}}
        return {"user": {"dense": dense, "sparse": ids(
            cfg.vocab_per_field, (1, cfg.n_sparse - 1, cfg.multi_hot))},
            "cand_ids": ids(cfg.vocab_per_field, n)}
    if isinstance(cfg, R.TwoTowerConfig):
        uf = ids(cfg.n_user_feats, (b, cfg.user_bag), lo=1)
        if d["kind"] == "serve":
            return {"user_feats": uf, "shortlist": ids(cfg.n_items, n)}
        return {"user_feats": uf, "cand_emb": torch.randn(
            n, cfg.tower_mlp[-1], generator=gen, device=dev)}
    if isinstance(cfg, R.Bert4RecConfig):
        return {"items": ids(cfg.n_items, (b, cfg.seq_len)),
                "cand_ids": ids(cfg.n_items, n)}
    raise TypeError(type(cfg))


def check_subset(arch, shape, inputs):
    """The part of a cell's inputs the CPU check runs on: the first
    RECSYS_CHECK_ROWS requests of a serve cell, the first
    RECSYS_CHECK_CANDS candidates of a retrieval cell."""
    def rows(x):
        return {k: rows(v) for k, v in x.items()} if isinstance(x, dict) \
            else x[:RECSYS_CHECK_ROWS]
    if shape == "serve_p99":
        if "batch" in inputs:
            return {"batch": rows(inputs["batch"])}
        first = next(iter(inputs))
        return {**inputs, first: rows(inputs[first])}
    last = list(inputs)[-1]
    return {**inputs, last: inputs[last][:RECSYS_CHECK_CANDS]}


def first_tensor(out):
    return out[0] if isinstance(out, tuple) else out


def phase_recsys(seed: int, dev) -> dict:
    """dlrm-rm2, two-tower-retrieval and bert4rec at full width: serve_p99
    and retrieval_cand on the card (launch counts, ms per step), each
    checked against the same step on the CPU; K5 (dlrm, two-tower) and K6
    (bert4rec) checked and timed on their serve_p99 inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps

    launches, main, results = {}, {}, {}
    for arch_id in RECSYS_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.config()
        torch.cuda.reset_peak_memory_stats()
        params = steps.init_fn(arch, "serve_p99", cfg, device=dev)(seed)
        host = None
        row = {"source": arch.source, "params": cfg.param_count(),
               "param_bytes": tree_bytes(params),
               "compute_dtype": str(cfg.compute_dtype)}
        for shape in ("serve_p99", "retrieval_cand"):
            step = steps.make_serve_step(arch, shape, cfg)
            inputs = cell_inputs(arch, shape, cfg, seed, dev)
            kern_mod = fa if arch_id == "bert4rec" else eb
            kname = kern_mod.__name__.rsplit(".", 1)[1]
            with first_call(kern_mod, kname) as seen:      # warm-up run
                step(params, *inputs.values())
            reset_model_launches()
            runs = 5
            out, ms = synced_ms(lambda: [step(params, *inputs.values())
                                         for _ in range(runs)][-1])
            counts = model_launches()
            launches[f"{arch_id}/{shape}"] = counts
            require(counts[kname] > 0, f"{arch_id} {shape}: {kname} never "
                                       f"launched")
            if kname == "flash_attention":      # BERT4Rec's encoder: mma
                require(counts["flash_attention_routes"] == fa_routes(
                    mma=counts[kname]),
                    f"{arch_id} {shape}: "
                    f"K6 launches by route {counts['flash_attention_routes']}")
            res = first_tensor(out)
            require(bool(torch.isfinite(res).all()),
                    f"{arch_id} {shape}: non-finite output")
            if shape == "serve_p99" and kname == "embedding_bag":
                main[arch_id] = measure_eb(seen[0][0])
            elif shape == "serve_p99":
                main[arch_id] = measure_fa(*seen[0], per_sequence_plain=False)
            # the same step on the CPU, on the check subset
            if host is None:
                host = tree_to(params, "cpu")
            sub = check_subset(arch, shape, inputs)
            cpu = step(host, *tree_to(sub, "cpu").values())
            card = (out if shape == "serve_p99"
                    else step(params, *sub.values()))
            card_t = tree_to(card, "cpu")
            if shape == "serve_p99":
                got, ref = first_tensor(card_t)[:RECSYS_CHECK_ROWS], cpu
            else:
                got, ref = card_t[0], cpu[0]
            diff = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check = {"on": (f"first {RECSYS_CHECK_ROWS} rows"
                            if shape == "serve_p99" else
                            f"first {RECSYS_CHECK_CANDS} candidates"),
                     "max_abs_diff": diff, "max_abs_ref": scale}
            if cfg.compute_dtype == torch.float32:
                tol = 1e-4 * scale + 1e-5
                check["tolerance"] = "max|d| <= 1e-4 max|ref| + 1e-5"
            else:
                tol = BF16_MODEL_RTOL * scale
                check["tolerance"] = f"max|d| <= {BF16_MODEL_RTOL} max|ref|"
            require(diff <= tol, f"{arch_id} {shape}: card vs CPU max|d| "
                                 f"{diff} > {tol}")
            if shape == "retrieval_cand":
                ids_card, ids_cpu = card_t[1], cpu[1]
                overlap = len(set(ids_card.tolist())
                              & set(ids_cpu.tolist())) / ids_cpu.numel()
                check["top100_overlap"] = overlap
                check["top100_ids_identical"] = bool(
                    torch.equal(ids_card, ids_cpu))
                if cfg.compute_dtype == torch.float32:
                    require(check["top100_ids_identical"],
                            f"{arch_id}: top-100 ids differ from the CPU's")
            row[shape] = {"ms_per_step": ms / runs, "runs": runs,
                          "launches_per_step": {
                              k: v / runs for k, v in counts.items()
                              if k in model_kernels()},
                          "out_shape": list(res.shape), "check": check}
            del out, card, card_t, inputs, cpu
        row["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        results[arch_id] = row
        del params, host
        torch.cuda.empty_cache()
    emit("recsys", models=results, launches=launches,
         kernel_check={k: {f: v[f] for f in ("route", "max_abs_err",
                                             "wrong_outputs_rejected",
                                             "shape") if f in v}
                       for k, v in main.items()},
         reduced=["serve_bulk (batch 262144) not run",
                  "din not run (it runs neither kernel; CPU tests only)",
                  "CPU checks on the first 8 rows / 65536 candidates"])
    return {"launches": launches, "main": main}


def phase_model_kernels(dev) -> list:
    """K5 and K6 against their plain versions on odd shapes; each K6 case
    launches the route ``fa.route`` names for it, and only that one, and is
    timed."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(4321)
    sweep = []
    bf, f32 = torch.bfloat16, torch.float32
    for (b, h, hkv, sq, skv, d, causal, off, dt, view) in [
            (2, 8, 2, 100, 100, 64, True, 0, bf, False),  # ragged, group 4
            (2, 32, 8, 1, 4128, 128, True, 4100, bf, False),  # decode
            (3, 4, 4, 1, 77, 32, True, 76, f32, False),   # Sq = 1, group 1
            (2, 8, 1, 33, 200, 64, True, 150, f32, False),  # group 8
            (2, 2, 2, 200, 200, 32, False, 0, bf, False),  # bidirectional
            (1, 16, 4, 130, 130, 128, False, 0, f32, False),
            (1, 4, 4, 5, 3, 64, True, 10, bf, False),     # short cache
            (1, 4, 2, 65, 64, 64, True, 0, f32, False),   # Sq > Skv
            (1, 8, 8, 64, 64, 128, True, 0, bf, False),
            # mma: ragged Sq and Skv, D 32/48/64/128, group 1/4/8, offsets,
            # bidirectional, Sq > Skv, a [B, S, H, D] view
            (1, 8, 1, 70, 300, 48, True, 230, bf, False),  # group 8, D 48
            (2, 4, 4, 130, 190, 128, True, 60, bf, False),  # group 1
            (1, 4, 4, 200, 150, 32, True, 0, bf, False),  # Sq > Skv
            (1, 16, 2, 333, 333, 64, False, 0, bf, False),  # group 8
            (1, 4, 1, 16, 1000, 64, True, 984, bf, False),  # 64 rows
            (2, 32, 8, 300, 1100, 64, True, 777, bf, True),  # view, GQA 4
            # split: group 1/4/8, D 32/48/128, Sq 2-4, an offset on a split
            # edge, a last split of one key, a [B, S, H, D] cache view
            (2, 8, 8, 2, 700, 32, True, 600, bf, False),  # group 1, D 32
            (1, 16, 4, 3, 1500, 48, True, 1400, bf, False),  # group 4, D 48
            (2, 16, 2, 2, 2000, 128, True, 1900, bf, False),  # 16 rows
            (2, 8, 2, 4, 700, 64, True, 640, bf, False),  # offset on an edge
            (4, 32, 8, 1, 4128, 64, True, 4096, bf, False),  # last: one key
            (4, 32, 8, 1, 4128, 64, True, 3000, bf, True),  # cache view
            (1, 4, 4, 1, 333, 64, False, 0, bf, False),   # bidirectional
            # mma above 16 rows: a partly filled block, D % 16 != 0
            (1, 1, 1, 17, 300, 64, True, 200, bf, False),  # 17 rows
            (1, 1, 1, 33, 300, 64, True, 200, bf, False),  # 33 rows
            (1, 4, 1, 15, 300, 64, True, 285, bf, False),  # 60 rows
            (1, 4, 2, 20, 130, 24, True, 40, bf, False),   # D 24, 40 rows
            # f32: decode with more key tiles than warps, a last tile of
            # one key, D 48/128, group 1/4/8, bidirectional, views
            (2, 8, 2, 1, 1500, 64, True, 1499, f32, False),  # 12 tiles
            (1, 8, 2, 1, 300, 64, True, 256, f32, False),   # last: one key
            (1, 4, 4, 65, 65, 64, True, 0, f32, False),     # last: one key
            (1, 4, 4, 70, 150, 48, True, 80, f32, False),   # D 48
            (1, 8, 8, 3, 500, 128, True, 497, f32, False),  # D 128 decode
            (2, 4, 2, 130, 190, 128, True, 60, f32, False),  # D 128 prefill
            (1, 8, 1, 2, 700, 64, True, 600, f32, False),   # 16 rows
            (1, 4, 4, 1, 333, 64, False, 0, f32, False),    # bidirectional
            (4, 32, 8, 1, 4128, 64, True, 3000, f32, True)]:  # cache view
        if view:            # [B, S, H, D] tensors, read through views
            q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                       .transpose(1, 2)
                       for s in ((b, sq, h, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d)))
        else:
            q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                       for s in ((b, h, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        kw = dict(causal=causal, kv_offset=off)
        way = fa.route(q, k)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        before = dict(fa.launches_by_route)
        out = fa.flash_attention(q, k, v, **kw)
        require(fa.launches_by_route == {**before, way: before[way] + 1},
                f"flash_attention sweep: launches {fa.launches_by_route} "
                f"after {before}, expected one on {way}")
        name = f"flash_attention {b}x{h}/{hkv}x{sq}x{skv}x{d}"
        if way == "f32":
            fa_close(f"{name}, three TF32 passes", out, ref,
                     fa.three_pass_bound(ref))
        sweep.append({"kernel": "flash_attention", "route": way,
                      "shape": [b, h, hkv, sq, skv, d], "causal": causal,
                      "kv_offset": off, "dtype": str(dt),
                      "bshd_view": view, "max_abs_err": fa_close(
                          name, out, ref, fa_tolerance(q, k, v, ref, kw)),
                      "ms": timings(functools.partial(
                          fa._launch, way, q, k, v, out, causal,
                          d ** -0.5, off))["ms"]})
    require({r["route"] for r in sweep} == set(fa.ROUTES),
            "flash_attention sweep: a route never ran")
    # the last two rows take the scalar path: D 3, and a table that
    # starts ``shift`` elements past a 16-byte boundary
    for (f, vocab, d, b, l, dt, shift) in [
            (1, 1000, 64, 37, 1, f32, 0), (1, 500, 256, 300, 16, f32, 0),
            (26, 1000, 64, 100, 1, f32, 0), (1, 5000, 64, 513, 16, bf, 0),
            (3, 200, 256, 10, 4, bf, 0), (1, 700, 3, 200, 16, f32, 0),
            (1, 700, 64, 200, 16, bf, 1)]:
        table = torch.randn(f * vocab * d + shift, generator=g,
                            device=dev).to(dt)[shift:].view(f, vocab, d)
        require((table.data_ptr() % 16 != 0) == (shift != 0),
                "embedding_bag sweep: table alignment")
        idx = torch.randint(0, vocab, (b, f, l), generator=g, device=dev,
                            dtype=torch.int32)
        w = torch.rand(b, f, l, generator=g, device=dev).to(dt)
        if l > 1:
            w[:, :, l // 2:] = 0                        # weight-0 padding
        idx[0, 0, 0] = vocab                            # out of range
        if f == 1:
            table, idx, w = table[0], idx[:, 0].contiguous(), \
                w[:, 0].contiguous()
        out = eb.embedding_bag(table, idx, w)
        require(torch.equal(out, eb.embedding_bag_plain(table, idx, w)),
                f"embedding_bag {f}x{vocab}x{d} B={b} L={l}: differs")
        sweep.append({"kernel": "embedding_bag",
                      "shape": [f, vocab, d, b, l], "dtype": str(dt),
                      "table_offset_elements": shift, "max_abs_err": 0.0})
    torch.cuda.synchronize()
    return sweep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=2 ** 20)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}; run the "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    dev = torch.device("cuda")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    from repro_torch.core import build_index
    from repro_torch.eval import make_graded_corpus
    from repro_torch.index import compress_index
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    log = build.build_all()
    n_tf32 = sass_count(log[fa.SOURCES["f32"]]["path"], "HMMA.1688.F32.TF32")
    require(n_tf32 > 0, "flash_attention_f32: no TF32 mma in its SASS")
    emit("build", seconds=time.perf_counter() - t0,
         sources={s: {"seconds": v["seconds"], "flags": build.flags(s),
                      "ptxas": v["ptxas"]} for s, v in log.items()},
         f32_sass={"HMMA.1688.F32.TF32": n_tf32})

    reduced = ["q8 paths profiled at k=10 only"]
    if args.n_docs != 2 ** 20:
        reduced.append(f"n_docs {args.n_docs} (of 2^20)")
    t0 = time.perf_counter()
    # make_corpus's corpus (n_rel 4, no partial tier, boost scale 1: its
    # defaults) plus a dense side at the two-tower config's width, 256
    graded = make_graded_corpus("splade_like", n_docs=args.n_docs,
                                n_terms=30522, n_queries=N_BATCHES * BATCH,
                                n_q_terms=16, n_rel=4, n_rel_partial=0,
                                avg_doc_terms=16, dim=256, seed=args.seed,
                                rel_boost_scale=1.0)
    corpus = graded.corpus
    t1 = time.perf_counter()
    merged = corpus.merged("scaled")
    t2 = time.perf_counter()
    index = build_index(merged, tile_size=2048, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emit("index", n_docs=index.n_docs, n_terms=index.n_terms, nnz=index.nnz,
         device_bytes=index.nbytes(), pad_len=index.pad_len,
         n_tiles=index.n_tiles, tile_size=index.tile_size,
         setup_seconds={"make_graded_corpus": t1 - t0, "merge": t2 - t1,
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
    phase_stream_build(corpus, q8, smi, dev)
    torch.cuda.empty_cache()

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
    sched_launches = phase_serve_sched(indexes, corpus, smi, dev)
    sharded_launches = phase_sharded(indexes, corpus, smi, dev)
    phase_rank_safe("fp32", index, (index.docids, index.w_b, index.w_l),
                    corpus, dev)
    phase_rank_safe("q8", q8, dequantized_postings(q8, index.docids), corpus,
                    dev)
    hybrid_launches = phase_hybrid(graded, indexes, smi, dev)
    del index, q8, indexes, served, graded
    torch.cuda.empty_cache()

    lm = phase_lm(args.seed, dev)
    torch.cuda.empty_cache()
    rec = phase_recsys(args.seed, dev)
    sweep = phase_model_kernels(dev)
    model_main = {"flash_attention": lm["main"]["prefill"],
                  "embedding_bag": rec["main"]["dlrm-rm2"]}
    model_other = {"flash_attention": {
        "decode": lm["main"]["decode"],
        "prefill_f32": lm["main"]["prefill_f32"],
        "decode_f32": lm["main"]["decode_f32"],
        "bert4rec": rec["main"]["bert4rec"]},
                   "embedding_bag": {"two-tower-retrieval":
                                     rec["main"]["two-tower-retrieval"]}}
    emit("kernels_models", main=model_main, other=model_other, sweep=sweep,
         tolerance="embedding_bag bit-equal; flash_attention " + FA_TOLERANCE)
    model_counts = {name: 0 for name in model_kernels()}
    route_counts = fa_routes()
    for counts in (*lm["launches"].values(), *rec["launches"].values()):
        for name in model_counts:
            model_counts[name] += counts[name]
        for way, n in counts["flash_attention_routes"].items():
            route_counts[way] += n

    src = "src/repro_torch/kernels/csrc/"
    where = {"guided_score_chunk": ("guided_score_tile.cu", 123),
             "guided_score_tile": ("guided_score_tile.cu", 36),
             "guided_score_chunk_q": ("guided_score_tile.cu", 413),
             "guided_score_tile_q": ("guided_score_tile.cu", 298)}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": f"src/repro/kernels/guided_score.py:{line}",
         "launches": launches[name][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None,
         "floor_ms": kern[name]["floor_ms"],
         **({"serve_sched_launches": sched_launches[name]}
            if name in sched_launches else {}),
         **({"sharded_launches": sharded_launches[name]}
            if name in sharded_launches else {}),
         **({"hybrid_launches": hybrid_launches[name]}
            if name in hybrid_launches else {})}
        for name, (cu, line) in where.items()]}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for name, cu, line in (("flash_attention", "flash_attention_mma.cu", 29),
                           ("embedding_bag", "embedding_bag.cu", 25)):
        m = model_main[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": model_counts[name], "max_abs_err": max(
                [m["max_abs_err"]] + [o["max_abs_err"] for o in
                                      model_other[name].values()]
                + [r["max_abs_err"] for r in sweep if r["kernel"] == name]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "at": m["shape"],
            "other": {k: {f: o[f] for f in timed if f in o}
                      for k, o in model_other[name].items()}})
        require(model_counts[name] > 0, f"{name} never launched on its path")
    # K6 by route: mma at prefill (and bert4rec), split at decode, f32 at
    # the float32 prefill and decode
    fa_main = {"mma": {"prefill": lm["main"]["prefill"],
                       "bert4rec": rec["main"]["bert4rec"]},
               "split": {"decode": lm["main"]["decode"]},
               "f32": {"prefill_f32": lm["main"]["prefill_f32"],
                       "decode_f32": lm["main"]["decode_f32"]}}
    summary["kernels"][-2]["routes"] = {
        way: {"source": src + fa.SOURCES[way], "launches": route_counts[way],
              "max_abs_err": max(
                  [o["max_abs_err"] for o in fa_main[way].values()]
                  + [r["max_abs_err"] for r in sweep
                     if r.get("route") == way]),
              **{k: {f: o[f] for f in timed + ("rotating",) if f in o}
                 for k, o in fa_main[way].items()}}
        for way in fa_main}
    for way, n in route_counts.items():
        require(n > 0, f"flash_attention: the {way} route never launched "
                       f"on its path")
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
