"""Dry run: each (arch x shape) cell's step traced once on a fake mesh, with
its work counted per device.

The port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell ahead of time on 256 or 512 fake XLA devices and reads XLA's cost and
memory analyses. Here a cell's step runs once, eagerly, in a fake world:

- **World:** one process holds a process group of the mesh's full size on
  torch's ``"fake"`` backend (``mesh.fake_world``): collectives return at
  once and move nothing.
- **Arguments:** the train state (``steps.state_specs``) and the inputs
  (``configs.shapes.input_specs``) as ``DTensor``s placed by the port's own
  rules (``dist.sharding``), each rank-0 shard a fake tensor (shape, dtype
  and device, no storage) under a ``FakeTensorMode``.
- **Counts:** ``Counter``, a dispatch mode that sees the ops each device
  runs on its own shards (it declines every ``DTensor``-level op, so torch
  hands it the local ops DTensor issues): FLOPs from torch's FLOP formulas
  (K5 and K6 are custom ops with their own; matrix-vector products get
  one here, ``_mv_flops``), the bytes each op reads and
  writes, the collectives by kind with their result bytes, and the peak of
  the bytes live.

The record keeps the reference's keys. Where they differ:

- ``flops`` counts one device's local ops (rank 0 of the mesh), as XLA's
  partitioned count does; every layer is traced, so ``extrapolated`` (the
  reference's fit from depths 1 and 2) equals the direct count on a cell
  whose layers are alike.
- ``bytes_accessed`` is the sum of operand and result bytes of every
  dispatched op but views: unfused, an upper bound on XLA's figure.
- ``memory``: ``argument_size_in_bytes`` (one device's shards of the state
  and inputs; a Python int argument, decode's cache length, counts as an
  int32), ``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of
  the bytes allocated during the step and live at once). There is no
  ``generated_code_size_in_bytes``: nothing is compiled.
- ``trace_s`` takes the place of ``lower_s`` and ``compile_s``; ``device_type``
  says which device the fake tensors named.

The steps run with Python int cache lengths: a decode cell's step attends
a full cache (``cache_len`` = its length - 1), as XLA's masked attention
counts it.

Run: ``python -m repro_torch.launch.dryrun --mesh both --device cpu``
(``--arch``, ``--shape``, ``--variant tp|opt``, ``--force``); records go
to ``artifacts/dryrun_torch/<mesh>__<arch>__<shape>[__variant].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..configs import all_cells, get_arch
from ..configs.shapes import input_specs
from ..dist.sharding import (activation_rules, input_shardings,
                             opt_shardings, param_shardings, placements)
from ..tree import leaves, leaves_up_to, unflatten
from .mesh import fake_world, make_mesh
from .steps import adapt_config, make_serve_step, make_train_step, state_specs

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
MESHES = {"pod16x16": (16, 16), "multipod2x16x16": (2, 16, 16)}
TRAIN_KINDS = ("train", "gnn_mol", "gnn_full", "gnn_sampled")

# the ops of torch's collective namespaces, by the reference's kinds
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _mv_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """A matrix-vector (or vector-vector) product: a multiply and an add per
    element of the matrix (torch's FLOP formulas cover mm, not mv)."""
    return 2 * math.prod(a_shape)


for _op in (torch.ops.aten.mv, torch.ops.aten.dot):
    if _op not in flop_registry:
        register_flop_formula(_op)(_mv_flops)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class Counter(TorchDispatchMode):
    """Counts of the ops one device runs, while active.

    Every op with a ``DTensor`` argument is declined (``NotImplemented``):
    DTensor then runs it as local ops on this rank's shards, redistributing
    with collectives where it must, and those come back here. The shape
    inference DTensor runs on whole-tensor stand-ins is not counted. For
    each local op: ``flops`` by torch's FLOP formulas (``flop_registry``);
    ``bytes_accessed``, the bytes of its tensor operands and results (views
    and allocations without a write excluded); ``collectives``, the count
    and result bytes of each of the reference's five kinds; and the bytes
    of new storages, live at once (``peak_bytes``), freed when torch frees
    them. Storages passed to ``ignore`` (the arguments') are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.ops = 0
        self.live = self.peak_bytes = 0
        self._storages: dict = {}
        self._known: set = set()
        self._in_shape_inference = False

    def ignore(self, tensors) -> None:
        for t in tensors:
            self._known.add(t.untyped_storage()._cdata)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def quiet(prop, op_schema):
            before, counter._in_shape_inference = (
                counter._in_shape_inference, True)
            try:
                return real(prop, op_schema)
            finally:
                counter._in_shape_inference = before
        self._restore = (ShardingPropagator, real)
        ShardingPropagator._propagate_tensor_meta_non_cached = quiet
        return super().__enter__()

    def __exit__(self, *exc):
        cls, real = self._restore
        cls._propagate_tensor_meta_non_cached = real
        return super().__exit__(*exc)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, out) -> None:
        import weakref
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in self._known:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._in_shape_inference:
            return out
        self.ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _KINDS.get(name)
            if kind is not None:
                res = out if func.namespace == "_c10d_functional" else args[0]
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += _nbytes(res)
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and not name.startswith("empty") and (
                func.namespace != "prim"):
            self.bytes_accessed += _nbytes(list(args) + list(
                kwargs.values())) + _nbytes(out)
            self._track(out)
        return out

    def record(self) -> dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()}}


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def argument_bytes(args) -> int:
    """One device's bytes of ``args``: each tensor's local shard, a Python
    int as an int32."""
    total = 0
    for leaf in leaves(args):
        if isinstance(leaf, torch.Tensor):
            total += _nbytes(_local(leaf))
        elif isinstance(leaf, int):
            total += 4
    return total


def trace(step, args) -> dict:
    """Run ``step(*args)`` once under a ``Counter``: in the fake mode of the
    arguments' shards where they are fake, with plain tensors made in the
    step taken as replicated (``implicit_replication``). Returns the
    counts, the memory record and the seconds."""
    from torch._guards import detect_fake_mode
    from torch.distributed.tensor.experimental import implicit_replication
    local = [_local(t) for t in leaves(args) if isinstance(t, torch.Tensor)]
    fake = detect_fake_mode(local)
    counter = Counter()
    counter.ignore(local)
    t0 = time.perf_counter()
    with (fake or contextlib.nullcontext()), implicit_replication(), counter:
        out = step(*args)
        out_bytes = sum(_nbytes(_local(t)) for t in leaves(out)
                        if isinstance(t, torch.Tensor))
    seconds = time.perf_counter() - t0
    return {**counter.record(),
            "memory": {"argument_size_in_bytes": argument_bytes(args),
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": counter.peak_bytes},
            "trace_s": seconds, "ops": counter.ops}


def with_depth(arch, cfg, depth: int | None):
    """Reduced-depth config variant for the linear fit of the counts (the
    reference's, where XLA counts a loop body once): ``(cfg, full depth)``,
    or ``(cfg, None)`` for a config with no stacked depth."""
    if depth is None:
        return cfg, None
    if arch.family == "lm":
        return (dataclasses.replace(cfg, n_layers=depth, unroll=True),
                cfg.n_layers)
    if arch.family == "gnn":
        return (dataclasses.replace(cfg, n_interactions=depth, unroll=True),
                cfg.n_interactions)
    if hasattr(cfg, "n_blocks"):  # bert4rec
        return (dataclasses.replace(cfg, n_blocks=depth, unroll=True),
                cfg.n_blocks)
    return cfg, None  # no scanned depth: costs are already exact


def place(tree, specs, mesh, device: str, fake_mode):
    """``tree``'s meta tensors as DTensors on ``mesh`` laid out by the ``P``
    specs ``specs`` (a tree of the same structure), each shard a fake
    tensor of ``fake_mode`` on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    metas = leaves(tree)
    pls = [placements(s, mesh) for s in leaves_up_to(tree, specs)]
    shapes = [compute_local_shape_and_global_offset(t.shape, mesh, pl)[0]
              for t, pl in zip(metas, pls)]
    with fake_mode:
        out = [DTensor.from_local(
            torch.empty(shape, dtype=t.dtype, device=device), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())
            for t, pl, shape in zip(metas, pls, shapes)]
    return unflatten(tree, out)


def cell_config(arch_id: str, shape: str, depth: int | None = None,
                variant: str = "tp"):
    """(arch, cfg, spec, effective variant) of one cell: ``variant`` "opt"
    is the reference's optimized config per cell kind: FSDP (two-axis
    ZeRO-3) for LM train, ``attn_chunk=512`` for LM prefill, an int8 KV
    cache for LM decode, and the sharded top-k for recsys retrieval."""
    arch = get_arch(arch_id)
    cfg, _ = with_depth(arch, adapt_config(arch, shape), depth)
    kind = input_specs(arch, shape, cfg)["kind"]
    eff = variant
    if variant == "opt":
        eff = "fsdp" if (arch.family == "lm" and kind == "train") else "tp"
        if arch.family == "lm" and kind == "prefill":
            cfg = dataclasses.replace(cfg, attn_chunk=512)
        if arch.family == "lm" and kind == "decode":
            cfg = dataclasses.replace(cfg, kv_quant=True)
    return arch, cfg, input_specs(arch, shape, cfg), eff


def cell_specs(arch, shape: str, cfg, spec: dict, mesh, eff: str) -> tuple:
    """(argument meta trees, their ``P`` spec trees) of one cell's step:
    (state, batch) for a train cell, (params, *inputs) for a serve cell."""
    in_sh = input_shardings(arch.family, cfg, mesh, spec, eff)
    st = state_specs(arch, shape, cfg)
    p_sh = param_shardings(arch.family, cfg, mesh, st["params"], eff)
    if spec["kind"] in TRAIN_KINDS:
        return ((st, spec["inputs"]["batch"]),
                ({"params": p_sh, "opt": opt_shardings(p_sh)},
                 in_sh["batch"]))
    return ((st["params"],) + tuple(spec["inputs"].values()),
            (p_sh,) + tuple(in_sh[k] for k in spec["inputs"]))


def cell_step(arch, shape: str, cfg, spec: dict, mesh, eff: str,
              variant: str = "tp"):
    """One cell's step function, with the rules of ``eff`` on ``mesh``. A
    prefill step builds a cache of ``spec["max_len"]`` positions; a decode
    step takes the cache length as a Python int."""
    rules = activation_rules(mesh, eff)
    if spec["kind"] in TRAIN_KINDS:
        return make_train_step(arch, shape, cfg, rules)
    return make_serve_step(arch, shape, cfg, rules,
                           max_len=spec.get("max_len"), mesh=mesh,
                           sharded_topk=(variant == "opt"))


def decode_length(spec: dict) -> int | None:
    """The cache length a decode cell's step runs at: its last position,
    so attention covers the whole cache as XLA's masked attention counts
    it; None for another kind."""
    if spec["kind"] != "decode":
        return None
    return spec["inputs"]["cache"]["k"].shape[2] - 1


def lower_spec(arch, shape: str, cfg, spec: dict, mesh, eff: str,
               variant: str = "tp", device: str = "cpu") -> tuple:
    """``(step, args)`` of (arch, shape) at ``cfg`` with the inputs of
    ``spec`` (``input_specs``' form) on ``mesh``: args are DTensors placed
    by ``param_shardings``, ``opt_shardings`` and ``input_shardings`` for
    ``eff`` ("tp" or "fsdp"), their shards fake tensors on ``device`` (in
    a ``FakeTensorMode`` of their own); decode's cache length is a Python
    int (``decode_length``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    trees, specs = cell_specs(arch, shape, cfg, spec, mesh, eff)
    args = place(trees, specs, mesh, device,
                 FakeTensorMode(allow_non_fake_inputs=True))
    if spec["kind"] == "decode":
        args = args[:-1] + (decode_length(spec),)
    return cell_step(arch, shape, cfg, spec, mesh, eff, variant), args


def lower_cell(arch_id: str, shape: str, mesh, depth: int | None = None,
               variant: str = "tp", device: str = "cpu") -> tuple:
    """``(step, args)`` of one cell on ``mesh`` (``lower_spec`` of the cell's
    config, at ``depth`` layers where given). ``trace(step, args)`` counts
    one run."""
    arch, cfg, spec, eff = cell_config(arch_id, shape, depth, variant)
    return lower_spec(arch, shape, cfg, spec, mesh, eff, variant, device)


def _lin(a: float, b: float, depth: int) -> float:
    """The reference's fit: f(2) - f(1) per layer, unless that delta is
    degenerate (at most a quarter of f(2)), then f(2) / 2."""
    per = b - a
    if per <= 0.25 * b:
        per = b / 2.0
    return max(a - per, 0.0) + depth * per


def extrapolate(arch_id: str, shape: str, mesh, variant: str,
                device: str) -> dict | None:
    """The counts at full depth fitted from traces at depths 1 and 2, as
    the reference fits its compiled probes; None for a config with no
    stacked depth."""
    arch = get_arch(arch_id)
    _, depth = with_depth(arch, adapt_config(arch, shape), 1)
    if depth is None or depth <= 1:
        return None
    probes = [trace(*lower_cell(arch_id, shape, mesh, d, variant, device))
              for d in (1, 2)]
    a, b = probes
    return {"depth": depth,
            "flops": _lin(a["flops"], b["flops"], depth),
            "bytes_accessed": _lin(a["bytes_accessed"], b["bytes_accessed"],
                                   depth),
            "collectives": {k: {"bytes": _lin(a["collectives"][k]["bytes"],
                                              b["collectives"][k]["bytes"],
                                              depth)}
                            for k in COLLECTIVES}}


def run_cell(arch_id: str, shape: str, mesh_name: str, mesh_shape=None,
             force: bool = False, variant: str = "tp",
             device: str = "cuda", write: bool = True,
             fit: bool = True) -> dict:
    """Trace one cell on a fake world of ``mesh_shape`` (by default the
    named production mesh's) and return its record, written to
    ``ART_DIR`` unless ``write`` is false (an earlier record is returned
    unless ``force``); ``fit=False`` leaves ``extrapolated`` out (None).
    The fake world is made here and destroyed before this returns; an
    existing default process group is refused."""
    mesh_shape = tuple(mesh_shape or MESHES[mesh_name])
    suffix = "" if variant == "tp" else f"__{variant}"
    out_path = ART_DIR / f"{mesh_name}__{arch_id}__{shape}{suffix}.json"
    if write and out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": arch_id, "shape": shape, "mesh": mesh_name,
           "variant": variant, "devices": math.prod(mesh_shape),
           "device_type": device, "ok": False}
    t0 = time.perf_counter()
    with fake_world(math.prod(mesh_shape)):
        try:
            mesh = make_mesh(*mesh_shape[-2:], pods=(
                mesh_shape[0] if len(mesh_shape) == 3 else 1),
                device_type=device)
            res = trace(*lower_cell(arch_id, shape, mesh, variant=variant,
                                    device=device))
            extrap = (extrapolate(arch_id, shape, mesh, variant, device)
                      if fit else None)
            rec.update(ok=True, trace_s=res["trace_s"],
                       memory=res["memory"], flops=res["flops"],
                       bytes_accessed=res["bytes_accessed"],
                       collectives=res["collectives"], extrapolated=extrap)
        except Exception as e:  # noqa: BLE001 - a failed cell is a record
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    if write:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '')[:120]})"
    print(f"[{mesh_name}] {arch_id} x {shape}: {status} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="tp", choices=("tp", "opt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cells = [(a, s) for a, s in all_cells()
             if (args.arch in (None, a)) and (args.shape in (None, s))]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("pod16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("multipod2x16x16")
    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for mesh_name in meshes:
        for arch_id, shape in cells:
            rec = run_cell(arch_id, shape, mesh_name, force=args.force,
                           variant=args.variant, device=args.device)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed "
          f"({time.perf_counter() - t0:.1f}s)")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
