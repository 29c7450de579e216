"""Training launcher: --arch <id> [--shape train_4k] [--smoke] [--device cuda].

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 --device cpu

The port of ``repro.launch.train``, with its flags and defaults: the
reduced (smoke) configuration of the arch (``--smoke`` is always on, as in
the reference), the family's data stream keyed by step, and the
fault-tolerant ``Trainer`` (checkpoints and ``metrics.jsonl`` under
``--out``, default ``runs/<arch>``; a rerun resumes from the latest
checkpoint). ``--device`` (default ``cuda``) holds the parameters, the
optimizer state and every batch; asking for CUDA without a GPU exits with
an error. ``--arch schnet`` trains its ``molecule`` cell by default
(``--shape full_graph_sm`` and the other graph cells train on 64-seed
subgraphs sampled from a 2048-node ``GraphStore``, as the reference's).
"""
from __future__ import annotations

import argparse


def data_provider(arch, shape, cfg, batch_size, device="cuda"):
    """``step -> batch`` of the arch's family on ``device``: the reference's
    streams (LM: Zipf tokens, 64 a row; SchNet: ``molecule_batch`` of 8
    atoms and 16 edges, or a 64-seed subgraph of a 2048-node
    ``GraphStore``; DLRM and DIN: ``recsys_batch``; two-tower and
    BERT4Rec: ``smoke_batch`` seeded by the step)."""
    from ..data.stream import (GraphStore, lm_batch, molecule_batch,
                               recsys_batch, to_device)
    from ..models import recsys as R
    from .steps import smoke_batch
    if arch.family == "lm":
        return lambda step: lm_batch(step, batch=batch_size, seq=64,
                                     vocab=cfg.vocab, device=device)
    if arch.family == "gnn":
        if shape == "molecule":
            return lambda step: molecule_batch(
                step, batch=batch_size, atoms=8, edges=16,
                n_types=cfg.n_atom_types, device=device)
        store = GraphStore(2048, 8192, cfg.d_feat, cfg.n_out)
        return lambda step: to_device(device, **store.sample(step, 64))
    if isinstance(cfg, R.DLRMConfig):
        return lambda step: recsys_batch(step, kind="dlrm", cfg=cfg,
                                         batch=batch_size, device=device)
    if isinstance(cfg, R.DINConfig):
        return lambda step: recsys_batch(step, kind="din", cfg=cfg,
                                         batch=batch_size, device=device)

    def fn(step):
        b = smoke_batch(arch, shape, cfg, seed=step, device=device)
        return b["batch"] if "batch" in b else b
    return fn


def main(argv=None) -> dict:
    """Train on ``argv`` (default: the command line); returns the
    ``Trainer.run`` result (final state, per-step losses) after printing
    the reference's summary line."""
    import numpy as np
    import torch

    from ..configs import ARCH_IDS, get_arch
    from ..models.transformer import NO_RULES
    from ..train.optimizer import AdamWConfig
    from ..train.trainer import Trainer, TrainerConfig
    from .steps import adapt_config, init_fn, loss_fn

    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the state and batches live (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available (pass "
                 f"--device cpu to train on the CPU)")
    arch = get_arch(args.arch)
    shape = args.shape or {"lm": "train_4k", "gnn": "molecule",
                           "recsys": "train_batch"}[arch.family]
    cfg = adapt_config(arch, shape, arch.smoke() if args.smoke else None)
    out = args.out or f"runs/{args.arch}"
    lfn = loss_fn(arch, shape, cfg, NO_RULES)
    trainer = Trainer(
        lfn, init_fn(arch, shape, cfg, device=dev),
        data_provider(arch, shape, cfg, args.batch, device=dev),
        TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 2,
                                                             10),
                      out_dir=out, log_every=5),
        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps))
    res = trainer.run()
    print(f"{args.arch}/{shape}: loss {res['losses'][0]:.4f} -> "
          f"{np.mean(res['losses'][-5:]):.4f} over {args.steps} steps")
    return res


if __name__ == "__main__":
    main()
