"""Serving launcher: the async scheduler over a synthetic corpus, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --preset splade_like
    PYTHONPATH=src python -m repro_torch.launch.serve --routing table8 --cache 256
    PYTHONPATH=src python -m repro_torch.launch.serve --shards 4
    repro-serve-torch --engine kernel --k 100     # installed console script

The port of ``repro.launch.serve``, with its flags, defaults, corpus,
index, requests and printed lines. Requests go through
``repro_torch.serve.AsyncRetrievalScheduler``: mixed-k micro-batches
(``--k-mix`` draws per-request depths), query-length routing (``--routing
table8``; ``--engine``/``--shards`` configure the single-route policy
otherwise), and an LRU response cache (``--cache N`` entries; the workload
repeats queries, so hits show up in the printed stats). ``--engine
kernel`` scores through the guided-score tile kernel; ``--shards N`` runs
the ``sharded`` engine, whose shards score their tiles through the same
kernel (``use_kernel=True``: the reference's launcher leaves its sharded
engine on the plain scan, whose results are the same). It serves over a
mesh of N ranks when the caller has initialised ``torch.distributed``
with N ranks (gloo on the CPU, NCCL on the card) and runs ``main`` on
each, else on the single-device emulation path (the same results). Every
rank of a mesh must form the same batches in the same order, since each
batch's search runs collectives across the ranks: there all requests
arrive at once (``--qps`` is not used; the reference paces them by
``--qps`` on every path), and ``--executors`` and ``--deadline-ms``,
whose batches depend on the clock, are refused.

``--device`` (default ``cuda``) places the index and every search; asking
for CUDA without a GPU exits with an error, nothing falls back to the CPU.
The reference's ``--host-devices`` (XLA's fake host devices) has no
counterpart here.

Observability: ``--metrics-port N`` serves the live registry over HTTP
(``/metrics`` Prometheus text, ``/metrics.json``, ``/traces``; port 0 binds
an ephemeral port and prints it); ``--trace`` records per-request spans and
prints the slowest request's trace after the run; ``--cost-model PATH``
loads a fitted ``obs.cost.CostModel`` and enables cost-sorted dispatch.
"""
from __future__ import annotations

import argparse


def _parser(engines) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro-serve-torch")
    ap.add_argument("--preset", default="splade_like")
    ap.add_argument("--docs", type=int, default=16384)
    ap.add_argument("--qps", type=float, default=200.0,
                    help="Poisson arrival rate; on a --shards mesh all "
                         "requests arrive at once instead")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--k", type=int, default=10,
                    help="retrieval depth per request")
    ap.add_argument("--k-mix", type=int, nargs="*", default=None,
                    help="draw per-request depths from this set "
                         "(mixed-k micro-batching), e.g. --k-mix 10 100")
    ap.add_argument("--engine", default="batched",
                    choices=sorted(set(engines) - {"dense"}),
                    help="retrieval engine for the single-route policy")
    ap.add_argument("--routing", default="none",
                    choices=("none", "table8"),
                    help="query-length routing policy (Table 8)")
    ap.add_argument("--cache", type=int, default=0,
                    help="LRU response-cache entries (0 = off)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--executors", type=int, default=0,
                    help="executor-pool worker threads, each with its "
                         "own Retriever replica and CUDA stream (0 = sync "
                         "inline dispatch, the deterministic default)")
    ap.add_argument("--admission-limit", type=int, default=0,
                    help="bounded admission queue: max pending rows "
                         "(0 = unbounded)")
    ap.add_argument("--admission-policy", default="block",
                    choices=("block", "reject", "shed"),
                    help="what submit() does when the admission queue "
                         "is full")
    ap.add_argument("--aging-ms", type=float, default=0.0,
                    help="priority aging: a queued request gains one "
                         "priority level per this many ms waited "
                         "(0 = strict priority)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: still-queued requests "
                         "are shed when the budget runs out, and the "
                         "workload reports goodput next to QPS")
    ap.add_argument("--retries", type=int, default=0,
                    help="max execution attempts per batch (0/1 = fail "
                         "on first error); failed batches requeue with "
                         "deterministic exponential backoff")
    ap.add_argument("--hedge", type=float, default=0.0,
                    help="hedge straggler batches after this many ms "
                         "in flight (0 = off; needs --executors >= 2); "
                         "first result wins")
    ap.add_argument("--swap-demo", action="store_true",
                    help="hot-swap demo: rebuild the index mid-stream "
                         "and swap it in behind the two-phase gate, "
                         "then report the generation + cache evictions")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the index over N tile-range shards "
                         "(implies --engine sharded); one rank per shard "
                         "when torch.distributed has N ranks, where all "
                         "requests arrive at once (--qps unused) and "
                         "--executors/--deadline-ms are refused")
    ap.add_argument("--exchange-every", type=int, default=0,
                    help="all-gather global theta_Gl every E tiles")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus), /metrics.json "
                         "and /traces on this port while the workload "
                         "runs (0 = ephemeral, printed at startup)")
    ap.add_argument("--trace", action="store_true",
                    help="record per-request spans; the slowest "
                         "request's trace prints after the run")
    ap.add_argument("--cost-model", default=None, metavar="PATH",
                    help="load a fitted obs.cost.CostModel (JSON) and "
                         "sort batches by predicted chunk count")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and the searches "
                         "(cuda, or cpu)")
    return ap


def _shard_mesh(n_shards: int):
    """The mesh of the default ``torch.distributed`` group when it has
    ``n_shards`` ranks, else None (the emulation path)."""
    import torch.distributed as dist

    from ..serve import make_shard_mesh
    if (n_shards > 1 and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == n_shards):
        return make_shard_mesh(n_shards)
    return None


def main(argv=None) -> dict:
    """Run the launcher on ``argv`` (default: the command line); returns
    the workload's stats, which it also prints."""
    import numpy as np
    import torch

    from ..core import build_index, twolevel
    from ..data import make_corpus
    from ..obs import CostModel, MetricsRegistry, Tracer
    from ..retrieval import SearchRequest, engine_names
    from ..serve import (AsyncRetrievalScheduler, RetryPolicy,
                         SchedulerConfig, run_workload, single_route,
                         table8_policy)

    ap = _parser(engine_names())
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available (pass "
                 f"--device cpu to serve on the CPU)")
    corpus = make_corpus(args.preset, n_docs=args.docs, n_terms=4096,
                         n_queries=64)
    index = build_index(corpus.merged("scaled"), tile_size=1024, device=dev)
    params = twolevel.fast(beta=args.beta).replace(schedule="impact")

    qps = args.qps
    if args.shards > 1 or args.engine == "sharded":
        if args.routing != "none":
            ap.error("--shards/--engine sharded cannot combine with "
                     "--routing (the sharded engine is a single route); "
                     "drop one of the flags")
        mesh = _shard_mesh(args.shards)
        if mesh is not None and (args.executors > 0
                                 or args.deadline_ms is not None):
            ap.error("on a mesh every rank must form the same batches: "
                     "--executors and --deadline-ms make them depend on "
                     "the clock; drop them")
        routing = single_route("sharded", n_shards=args.shards, mesh=mesh,
                               exchange_every=args.exchange_every,
                               use_kernel=True)
        path = "mesh" if mesh is not None else "emulated"
        print(f"# sharded serving: {args.shards} shards ({path})")
        if mesh is not None:
            # every rank must form the same batches: all arrive at once
            qps = float("inf")
    elif args.routing == "table8":
        # --engine still matters under routing: it serves the long class
        routing = table8_policy(long_engine=args.engine)
        print(f"# routing: table8 (short -> fine chunks, "
              f"long -> {args.engine})")
    else:
        routing = single_route(args.engine)
        print(f"# serving engine: {args.engine}")

    retry = (RetryPolicy(max_attempts=args.retries)
             if args.retries > 1 else None)
    tracer = Tracer() if args.trace else None
    registry = MetricsRegistry()
    cost_model = (CostModel.load(args.cost_model)
                  if args.cost_model else None)
    if cost_model is not None:
        print(f"# cost model: {args.cost_model} "
              f"(r2={cost_model.r2:.3f}, n={cost_model.n_samples}) — "
              f"cost-sorted dispatch on")
    sched = AsyncRetrievalScheduler(
        index, params,
        SchedulerConfig(max_batch=args.max_batch, cache_size=args.cache,
                        executors=args.executors,
                        admission_limit=args.admission_limit,
                        admission_policy=args.admission_policy,
                        aging_ms=args.aging_ms, retry=retry,
                        hedge_ms=args.hedge,
                        tracer=tracer, metrics=registry,
                        cost_model=cost_model,
                        sort_batches_by_cost=cost_model is not None),
        routing=routing, device=dev)
    server = None
    if args.metrics_port is not None:
        from ..obs import MetricsServer
        server = MetricsServer(registry, tracer,
                               port=args.metrics_port,
                               extra=sched.stats)
        print(f"# metrics: http://127.0.0.1:{server.port}/metrics "
              f"(.json, /traces)", flush=True)
    try:
        rng = np.random.default_rng(0)
        k_pool = args.k_mix if args.k_mix else [args.k]
        reqs = [SearchRequest(terms=corpus.queries[i % 64],
                              weights_b=corpus.q_weights_b[i % 64],
                              weights_l=corpus.q_weights_l[i % 64],
                              k=int(rng.choice(k_pool)),
                              deadline_ms=args.deadline_ms)
                for i in range(args.requests)]
        if args.swap_demo:
            # serve half the stream, hot-swap a rebuilt index, serve the rest
            mid = len(reqs) // 2
            if args.executors > 0:
                sched.start()
            stats = run_workload(sched, reqs[:mid], qps=qps)
            gen = sched.swap_index(build_index(corpus.merged("scaled"),
                                               tile_size=1024, device=dev))
            print(f"# hot-swap: installed generation {gen} "
                  f"(cache evictions: "
                  f"{sched.stats()['cache_gen_evictions']})")
            stats = run_workload(sched, reqs[mid:], qps=qps)
            if args.executors > 0:
                sched.close()
        elif args.executors > 0:
            print(f"# executor pool: {args.executors} workers "
                  f"(warming routing grid...)")
            with sched:
                stats = run_workload(sched, reqs, qps=qps)
        else:
            stats = run_workload(sched, reqs, qps=qps)
        print(stats, flush=True)
        if tracer is not None:
            slow = tracer.slowest("request")
            if slow is not None:
                print(f"# slowest request (trace {slow}):")
                for span in tracer.trace(slow):
                    print(f"#   {span['name']}: "
                          f"{(span['t_end'] - span['t_start']) * 1e3:.2f}ms "
                          f"{span['attrs']}")
    finally:
        if server is not None:
            server.close()
    return stats


def cli() -> None:
    """``repro-serve-torch`` console entry."""
    main()


if __name__ == "__main__":
    cli()
