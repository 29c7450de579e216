"""Decode ms per step of the port's LMs, for comparing two source trees on
one card.

    python3 scripts/decode_ab.py --src SRC_DIR --label NAME [--steps 24]

Imports ``repro_torch`` from ``SRC_DIR`` (a checkout's ``src``), builds its
kernels, and times greedy decode steps at the shapes of ``chip_smoke.py``'s
``lm`` and ``lm_moe`` phases: granite-3-2b (40 layers) and
granite-moe-1b-a400m (24 layers), bf16 compute, batch 4, a 4096-token
prompt prefilled into a cache of 4096 + steps positions. Each step is timed
alone on the host clock, ending in a synchronize; prints one JSON line with
the median and every step's ms, the card's name and power limit. Run it for
two trees in turns in one call (a, b, b, a) to compare them.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    batch, prompt = 4, 4096
    out = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "batch": batch, "prompt": prompt, "steps": args.steps}
    for arch_id in ("granite-3-2b", "granite-moe-1b-a400m"):
        arch = get_arch(arch_id)
        cfg = arch.config()
        master = steps.init_fn(arch, "prefill_32k", cfg, device=dev)(
            args.seed)
        params = T.compute_params(cfg, master)
        del master
        tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
            1, cfg.vocab, (batch, prompt)).astype(np.int32)).to(dev)
        prefill = steps.make_serve_step(arch, "prefill_32k", cfg,
                                        max_len=prompt + args.steps + 1)
        decode = steps.make_serve_step(arch, "decode_32k", cfg)
        with torch.no_grad():
            logits, cache = prefill(params, tokens)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            times = []
            for i in range(args.steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = decode(params, tok, cache, prompt + i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        times = times[1:]                  # the first step warms up
        out[arch_id] = {"n_layers": cfg.n_layers,
                        "decode_ms_median": statistics.median(times),
                        "decode_ms": times}
        del params, cache, logits, lg
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
