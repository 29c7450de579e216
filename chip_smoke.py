"""Drive the PyTorch/CUDA port (``repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--seed 0] [--n-docs 1048576]

Phases, one JSON line each:

  device   the card (nvidia-smi name and power limit); stops without CUDA
  build    nvcc builds every kernel of the path from ``src/repro_torch``
  index    a seeded splade_like corpus of 2^20 docs over the 30522-term
           BERT WordPiece vocabulary, indexed onto the card
  kernels  each kernel against its plain PyTorch version on real main-path
           inputs and odd shapes; times beside the card's bound
  serve    Retriever.search on 4 batches of 16 queries at k=10 and k=100
           through guided_score_chunk (traversal="chunked_fused") and
           guided_score_tile (traversal="chunked"), with launch counts;
           one batch of each under the profiler (device busy and idle
           share); the tile path against the plain batched path, and a
           rank-safe run against an exhaustive top-k computed on the card

Then the kernels' summary line, the nvidia-smi line and, last, the one-line
verdict. Any failed check raises and the script exits non-zero.
"""
from __future__ import annotations

import argparse
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def compare(name, out_k, out_p) -> float:
    """Masks (rows 3-4) identical, rows 0-2 within 1e-5 * max|plain|."""
    require(out_k.shape == out_p.shape, f"{name}: shape {tuple(out_k.shape)}"
            f" != {tuple(out_p.shape)}")
    require(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    require(torch.equal(out_k[..., 3:, :], out_p[..., 3:, :]),
            f"{name}: masks differ")
    err = (out_k[..., :3, :] - out_p[..., :3, :]).abs().max().item()
    scale = out_p[..., :3, :].abs().max().item()
    require(err <= 1e-5 * scale, f"{name}: max|d| {err} > 1e-5 * {scale}")
    return err


def bound(n_postings: int, live_tiles: int, all_tiles: int, nq: int,
          tile_size: int, rows: int, has_skip: bool) -> dict:
    """Least time for the same work on an H100 SXM: each posting of a live
    tile read once (offs, wb, wl: 12 B) plus one padding entry per run,
    the planner rows (essential, prefix_beta), skip flags and th_lo read
    once, every output row written once; against float32 operations of
    the freeze loop and the combines (about 5 per slot and term, 6 per
    slot for the outputs)."""
    nbytes = (12 * n_postings + 4 * nq * live_tiles + 8 * nq * live_tiles
              + (4 * all_tiles if has_skip else 0) + 4 * rows
              + 20 * tile_size * all_tiles)
    ops = live_tiles * tile_size * (5 * nq + 6)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def phase_kernels(index, corpus, dev):
    from repro_torch.core import twolevel
    from repro_torch.core.plan import chunk_schedule
    from repro_torch.core.traversal import (Carry, _chunk_step_fused,
                                            make_context, step_inputs)
    from repro_torch.kernels import guided_score as gs

    # One real chunk and one real tile of the main path: batch 0 under the
    # fast preset, after its first chunk has set the thresholds.
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
    x1 = step_inputs(ctx, carry, second, index.n_tiles)
    x2 = step_inputs(ctx, carry, second[:, 0])
    coef = (ctx.alpha, ctx.beta, ctx.gamma)
    S = index.tile_size
    k1_args = (x1.offs, x1.wb, x1.wl, x1.essential.float(), x1.prefix_beta,
               x1.skip.to(torch.int32), x1.th_lo, *coef)
    k2_args = (x2.offs, x2.wb, x2.wl, x2.essential.float(), x2.prefix_beta,
               x2.th_lo, *coef)

    def k1():
        return gs.guided_score_chunk(*k1_args, tile_size=S)

    def p1():
        return gs.guided_score_chunk_plain(*k1_args, tile_size=S)

    def k2():
        return gs.guided_score_tile(*k2_args, tile_size=S)

    def p2():
        return gs.guided_score_tile_plain(*k2_args, tile_size=S)

    err1 = compare("guided_score_chunk main", k1(), p1())
    err2 = compare("guided_score_tile main", k2(), p2())
    torch.cuda.synchronize()

    # Odd shapes: Nq not a power of 2, P < S, S below block_s, S not a
    # multiple of block_s, a fully skipped chunk, Nq large enough that the
    # launcher must shrink block_s to fit shared memory.
    rng = np.random.default_rng(1234)
    sweep = []
    for (b, c, nq, p, s, skip_mode) in [
            (3, 4, 5, 96, 384, "mixed"), (4, 2, 7, 300, 1000, "mixed"),
            (2, 3, 16, 64, 2048, "all"), (2, 2, 64, 128, 1024, "none"),
            (1, 1, 1, 8, 64, "none")]:
        offs, wb, wl, ess, pb = random_inputs(rng, (b, c), nq, p, s, dev)
        skip = {"all": np.ones((b, c)), "none": np.zeros((b, c)),
                "mixed": rng.random((b, c)) < 0.4}[skip_mode]
        skip = torch.from_numpy(skip.astype(np.int32)).to(dev)
        th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(dev)
        th[0] = -math.inf
        args = (offs, wb, wl, ess, pb, skip, th, 0.7, 0.2, 0.05)
        e1 = compare(f"chunk {b}x{c}x{nq}x{p} S={s}",
                     gs.guided_score_chunk(*args, tile_size=s),
                     gs.guided_score_chunk_plain(*args, tile_size=s))
        targs = (offs[:, 0].contiguous(), wb[:, 0].contiguous(),
                 wl[:, 0].contiguous(), ess[:, 0].contiguous(),
                 pb[:, 0].contiguous(), th, 1.0, 0.3, 0.05)
        e2 = compare(f"tile {b}x{nq}x{p} S={s}",
                     gs.guided_score_tile(*targs, tile_size=s),
                     gs.guided_score_tile_plain(*targs, tile_size=s))
        sweep.append({"shape": [b, c, nq, p, s], "skip": skip_mode,
                      "chunk_err": e1, "tile_err": e2})
    torch.cuda.synchronize()

    live1 = ~x1.skip
    n1 = int(((x1.offs >= 0) & live1[..., None, None]).sum())
    b1 = bound(n1, int(live1.sum()), live1.numel(), x1.offs.shape[-2], S,
               BATCH, True)
    n2 = int((x2.offs >= 0).sum())
    b2 = bound(n2, BATCH, BATCH, x2.offs.shape[-2], S, BATCH, False)
    times = {}
    for name, kern, plain in (("guided_score_chunk", k1, p1),
                              ("guided_score_tile", k2, p2)):
        t_plain = timings(plain)
        times[name] = {**timings(kern), "plain_ms": t_plain["ms"],
                       "plain_event_ms": t_plain["event_ms"]}
    result = {
        "guided_score_chunk": {"max_abs_err": err1,
                               **times["guided_score_chunk"], **b1,
                               "shape": list(x1.offs.shape),
                               "live_tiles": int(live1.sum()),
                               "postings": n1},
        "guided_score_tile": {"max_abs_err": err2,
                              **times["guided_score_tile"], **b2,
                              "shape": list(x2.offs.shape),
                              "live_tiles": BATCH, "postings": n2},
    }
    emit("kernels", main=result, sweep=sweep,
         tolerance="masks identical; rows 0-2 max|d| <= 1e-5*max|plain|")
    return result


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

def exhaustive_topk(index, tile_lo, tile_hi, qt, qwb, qwl, gamma, k):
    """Exact top-k of the gamma-combined score of one query: every posting
    of its terms scatter-added (float64) into a dense [n_docs] row on the
    card; ties by ascending docid. Returns (ids, scores, dense scores)."""
    dev = index.device
    s = torch.zeros(index.n_docs, dtype=torch.float64, device=dev)
    for t, wbq, wlq in zip(qt.tolist(), qwb.tolist(), qwl.tolist()):
        lo, hi = tile_lo[t], tile_hi[t]
        d = index.docids[lo:hi].long()
        s.index_add_(0, d, gamma * wbq * index.w_b[lo:hi].double()
                     + (1.0 - gamma) * wlq * index.w_l[lo:hi].double())
    s = s.float()
    vals, ids = torch.sort(s, descending=True, stable=True)
    return ids[:k].cpu().numpy(), vals[:k].cpu().numpy(), s


def check_rank_safe(resp, index, corpus, rows, gamma, tile_lo, tile_hi):
    """Traversal top-k == exhaustive top-k: scores within rtol 2e-5 /
    atol 1e-4; ids equal except where exhaustive scores tie within that
    tolerance (visit order vs docid order)."""
    mismatched = 0
    for j, qi in enumerate(range(rows.start, rows.stop)):
        ids_x, vals_x, dense = exhaustive_topk(
            index, tile_lo, tile_hi,
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


def phase_serve(index, corpus, dev):
    from repro_torch.core import twolevel
    from repro_torch.core.traversal import STAT_KEYS
    from repro_torch.kernels import guided_score as gs
    from repro_torch.retrieval import Retriever

    fast = twolevel.fast()
    r_k1 = Retriever.open(index, fast, engine="kernel",
                          traversal="chunked_fused", device=dev)
    r_k2 = Retriever.open(index, fast, engine="kernel", traversal="chunked",
                          device=dev)
    r_plain = Retriever.open(index, fast, engine="batched",
                             traversal="chunked", device=dev)
    for r in (r_k1, r_k2):      # first-call set-up (allocator, launches)
        r.search(terms=corpus.queries[:BATCH],
                 weights_b=corpus.q_weights_b[:BATCH],
                 weights_l=corpus.q_weights_l[:BATCH], k=KS[0])

    launches, served = {}, {}
    paths = (("guided_score_chunk", r_k1), ("guided_score_tile", r_k2))
    for name, r in paths:
        gs.reset_launches()
        resps = {k: run_batches(r, corpus, k) for k in KS}
        launches[name] = {fn.__name__: fn.launches for fn in gs.KERNELS}
        served[name] = resps
        require(launches[name][name] > 0, f"{name} never launched")
        for k, batch in resps.items():
            for resp in batch:
                require(resp.ids.shape == (BATCH, k)
                        and bool(np.isfinite(resp.scores).all())
                        and bool((np.diff(resp.scores, axis=1) <= 0).all())
                        and bool(((resp.ids >= 0)
                                  & (resp.ids < index.n_docs)).all()),
                        f"{name} k={k}: malformed response")
        emit("serve", path=name, traversal=r.engine.traversal,
             launches=launches[name],
             launches_per_batch=launches[name][name] / (N_BATCHES * len(KS)),
             **{f"k{k}": summarize(v) for k, v in resps.items()})

    # The K2 chunked path against the plain batched chunked path.
    for k in KS:
        for a, b in zip(served["guided_score_tile"][k],
                        run_batches(r_plain, corpus, k)):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6)
            for key in STAT_KEYS + ("chunks_dispatched", "n_chunks"):
                np.testing.assert_array_equal(a.stats[key], b.stats[key])
    emit("serve_parity", check="kernel chunked == batched chunked (plain)",
         ids="identical", stats="identical", scores="rtol 1e-6")
    emit("profile", **{name: [profile_search(r, corpus, k) for k in KS]
                        for name, r in paths})

    # Rank-safe chunked_fused against the exhaustive top-k on the card.
    gamma = 0.2
    r_safe = Retriever.open(index, twolevel.original(gamma=gamma),
                            engine="kernel", traversal="chunked_fused",
                            device=dev)
    tile_lo = index.tile_ptr[:, 0].tolist()
    tile_hi = index.tile_ptr[:, -1].tolist()
    mism = {}
    for k in KS:
        mism[k] = sum(
            check_rank_safe(resp, index, corpus,
                            slice(i * BATCH, (i + 1) * BATCH), gamma,
                            tile_lo, tile_hi)
            for i, resp in enumerate(run_batches(r_safe, corpus, k)))
    emit("rank_safe", preset="original(gamma=0.2)",
         traversal="chunked_fused", queries=N_BATCHES * BATCH,
         ids_differing_within_tie_tolerance={str(k): v
                                             for k, v in mism.items()},
         tolerance="rtol 2e-5, atol 1e-4")
    return launches


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
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, flags=build.NVCC_FLAGS,
         sources={s: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                  for s, v in log.items()})

    reduced = []
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
    del merged
    emit("index", n_docs=index.n_docs, n_terms=index.n_terms, nnz=index.nnz,
         device_bytes=index.nbytes(), pad_len=index.pad_len,
         n_tiles=index.n_tiles, tile_size=index.tile_size,
         setup_seconds={"make_corpus": t1 - t0, "merge": t2 - t1,
                        "layout_and_upload": t3 - t2}, reduced=reduced)

    kern = phase_kernels(index, corpus, dev)
    launches = phase_serve(index, corpus, dev)

    src = "src/repro_torch/kernels/csrc/guided_score.cu"
    replaces = {"guided_score_chunk": "src/repro/kernels/guided_score.py:123",
                "guided_score_tile": "src/repro/kernels/guided_score.py:36"}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": launches[name][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None}
        for name in ("guided_score_chunk", "guided_score_tile")]}
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
