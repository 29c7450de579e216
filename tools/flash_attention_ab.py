"""A/B measurements of K6's "mma" kernel and of the model checks it feeds,
for comparing kernel sources or source trees on one card in one call.

    python3 tools/flash_attention_ab.py kernels --sources A.cu B.cu [...]
    python3 tools/flash_attention_ab.py moe-seeds --tree DIR --seeds 0 1 2
    python3 tools/flash_attention_ab.py lm-profile --tree DIR

Each mode imports ``chip_smoke.py`` from a tree (``--tree``, by default
this checkout), and with it that tree's ``src/repro_torch``, and uses its
helpers: ``device_ms`` (CUDA events around launches queued behind a spin
kernel), ``fa_bound``, ``profile_call`` and the model checks. Each prints
one JSON line, with the card's name and power limit (``nvidia-smi``).

- ``kernels``: builds each given ``flash_attention_mma.cu`` (nvcc, with the
  flags ``build.py`` gives that source) and runs it at the shapes
  ``chip_smoke.py``'s lm, lm_moe and recsys phases give the "mma" route,
  q, k and v read through views of [B, S, H, D] tensors as the models pass
  them, and at the lm_moe check's cache-free forward. Per source and
  shape: the largest error over ``fa.tolerance`` (the first sequence), the
  error against a float64 plain version (RMS and mean), the share of
  outputs that differ from the first source's; then its time, and
  ``scaled_dot_product_attention``'s (``enable_gqa``), with the sources in
  the order A B .. B A.
- ``moe-seeds``: each MoE cell of the tree's ``MOE_CELLS`` at each seed,
  its weights and prompts made as its lm_moe phase makes them, through that
  phase's decode against the cache-free forward
  (``moe_decode_vs_forward``) at each number of decode steps; the checks
  that fail are recorded, not raised.
- ``lm-profile``: the tree's granite-3-2b prefill (the lm phase's batch and
  prompt, seed 0) under ``profile_call``: wall and busy ms, the idle share
  and K6's share of the busy time.
"""
import argparse
import ctypes
import dataclasses
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "flash_attention_mma.cu"
# name: batch, heads, kv heads, query rows, cache rows, head dim, causal
SHAPES = {
    "granite-3-2b prefill": (4, 32, 8, 4096, 4128, 64, True),
    "granite-moe prefill": (4, 16, 8, 4096, 4128, 64, True),
    "qwen3-moe prefill": (4, 32, 4, 4096, 4104, 64, True),
    "granite-moe forward": (4, 16, 8, 4104, 4104, 64, True),
    "bert4rec": (512, 2, 2, 200, 200, 32, False),
}


def smoke(tree):
    """The tree's ``chip_smoke`` module (it puts the tree's ``src`` first
    on the path)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import chip_smoke
    return chip_smoke


def compile_mma(path: Path):
    """``flash_attention_mma_launch`` of the library built from ``path``,
    and ptxas's report."""
    from repro_torch.kernels import build
    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "ab" / f"{path.stem}_{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.flags(SOURCE), "-o",
                           str(out), str(path)], capture_output=True,
                          text=True, check=True)
    fn = ctypes.CDLL(str(out)).flash_attention_mma_launch
    fn.argtypes = build.SIGNATURES[SOURCE]["flash_attention_mma_launch"]
    fn.restype = ctypes.c_int
    return fn, proc.stderr.strip()


def plain64(torch, q, k, v, causal):
    """Attention of one sequence in float64 (kv_offset 0, scale d^-0.5)."""
    h, sq, d = q.shape[1:]
    g = h // k.shape[1]
    kk = k.double().repeat_interleave(g, 1)
    s = q.double() @ kk.transpose(-1, -2) * d ** -0.5
    if causal:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
    return torch.softmax(s, -1) @ v.double().repeat_interleave(g, 1)


def kernels(cs, args) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    built = [compile_mma(Path(p)) for p in args.sources]
    names = [Path(p).stem for p in args.sources]
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cycles = cs.spin_cycles_per_ms()
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"sources": dict(zip(names, args.sources)),
           "ptxas": {n: p for n, (_, p) in zip(names, built)},
           "timing": "device_ms: events around 25 launches behind a spin "
                     "kernel; sources timed A B .. B A", "shapes": {}}
    for shape, (b, h, hkv, sq, skv, d, causal) in SHAPES.items():
        x = torch.randn(b, sq, h, d, generator=g, device=dev).bfloat16()
        cache = torch.randn(2, b, skv, hkv, d, generator=g,
                            device=dev).bfloat16()
        q, k, v = (x.transpose(1, 2), cache[0].transpose(1, 2),
                   cache[1].transpose(1, 2))
        ref = fa.flash_attention_plain(q[:1], k[:1], v[:1], causal=causal)
        tol = fa.tolerance(q[:1], k[:1], v[:1], ref, "mma", causal=causal)
        ref64 = plain64(torch, q[:1], k[:1], v[:1], causal)
        outs, row = [], {"q": [b, h, sq, d], "k": [b, hkv, skv, d],
                         "causal": causal, "sources": {}}
        for name, (fn, _) in zip(names, built):
            o = torch.empty_like(q)
            geometry = (b, h, hkv, sq, skv, d, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                        int(causal), 0, d ** -0.5)
            launch = functools.partial(fn, *(ctypes.c_void_p(t.data_ptr())
                                             for t in (q, k, v, o)),
                                       *geometry, stream)
            if launch() != 0:
                raise RuntimeError(f"{name}: launch failed at {shape}")
            torch.cuda.synchronize()
            err = (o[:1].double() - ref64)
            row["sources"][name] = {
                "max_err_over_tolerance": float(
                    ((o[:1].float() - ref.float()).abs() / tol).max()),
                "rms_err_vs_float64": float(err.pow(2).mean().sqrt()),
                "mean_err_vs_float64": float(err.mean()),
                "differs_from_first_share": float(
                    (o != outs[0][0]).float().mean()) if outs else 0.0,
                "ms": []}
            outs.append((o, launch))
        for name, (o, launch) in [*zip(names, outs),
                                  *reversed(list(zip(names, outs)))]:
            row["sources"][name]["ms"].append(
                cs.device_ms(launch, cycles)["ms"])
        sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                 is_causal=causal, enable_gqa=hkv != h)
        row["sdpa_ms"] = cs.device_ms(sdpa, cycles)["ms"]
        bound = cs.fa_bound(q, k, causal, 0)
        row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        out["shapes"][shape] = row
        del x, cache, q, k, v, ref, tol, ref64, outs
        torch.cuda.empty_cache()
    return out


def moe_seeds(cs, args) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    failed = []

    def record(cond, what):
        if not cond:
            failed.append(what)

    cs.require = record
    build.build_all()
    dev = torch.device("cuda")
    runs = []
    for arch_id, n_layers, _ in cs.MOE_CELLS:
        arch = get_arch(arch_id)
        cfg = arch.config()
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        for seed in args.seeds:
            master = steps.init_fn(arch, "prefill_32k", cfg, device=dev)(seed)
            params = T.compute_params(cfg, master)
            del master
            tokens = torch.from_numpy(np.random.default_rng(seed).integers(
                1, cfg.vocab, (cs.MOE_BATCH, cs.MOE_PROMPT)).astype(
                    np.int32)).to(dev)
            for n in args.steps:
                cs.MOE_CHECK_STEPS = n
                failed.clear()
                r = cs.moe_decode_vs_forward(arch, cfg, params, tokens)
                runs.append({
                    "arch": arch_id, "seed": seed, "steps": n,
                    "positions": r["positions"],
                    "positions_same_experts": r["positions_same_experts"],
                    "strict": r["argmax"]["strict"]["positions"],
                    "max_abs_diff": r["max_abs_diff"],
                    "max_abs_logit": r["max_abs_logit"],
                    "routing_decisions_differing":
                        r["routing_decisions_differing"],
                    "failed": list(failed)})
            del params, tokens
            torch.cuda.empty_cache()
    return {"strict_min": cs.LM_STRICT_MIN, "runs": runs}


def lm_profile(cs, args) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    build.build_all()
    dev = torch.device("cuda")
    arch = get_arch(cs.LM_ARCH)
    cfg = arch.config()
    master = steps.init_fn(arch, "prefill_32k", cfg, device=dev)(0)
    params = T.compute_params(cfg, master)
    del master
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (cs.LM_BATCH, cs.LM_PROMPT)).astype(np.int32)).to(dev)
    prefill = steps.make_serve_step(arch, "prefill_32k", cfg,
                                    max_len=cs.LM_MAX_LEN)
    prof = cs.profile_call(lambda: prefill(params, tokens))
    k6 = sum(e["ms"] for e in prof["port_kernels"]
             if "flash_attention" in e["name"])
    return {"arch": cs.LM_ARCH, "batch": cs.LM_BATCH,
            "prompt": cs.LM_PROMPT, "k6_ms": k6,
            "k6_share_of_busy": k6 / prof["device_busy_ms"], **prof}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("kernels", "moe-seeds", "lm-profile"))
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--sources", nargs="+", default=[
        str(ROOT / "src" / "repro_torch" / "kernels" / "csrc" / SOURCE)])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--steps", nargs="+", type=int, default=[8])
    args = ap.parse_args()
    cs = smoke(args.tree)
    if not cs.torch.cuda.is_available():
        print("flash_attention_ab: CUDA is not available", file=sys.stderr)
        return 2
    run = {"kernels": kernels, "moe-seeds": moe_seeds,
           "lm-profile": lm_profile}[args.mode]
    print(json.dumps({"mode": args.mode, "tree": args.tree,
                      "nvidia_smi": cs.nvidia_smi(), **run(cs, args)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
