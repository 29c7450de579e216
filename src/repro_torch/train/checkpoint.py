"""Fault-tolerant checkpointing: atomic, keep-N, auto-resume.

The port of ``repro.train.checkpoint``, with its on-disk layout:
``<dir>/step_<n>/arrays.npz`` (``leaf_<i>`` for the i-th leaf in visiting
order: dict keys sorted, lists in order) and ``manifest.json`` (the
leaves' ``jax.tree_util.keystr`` paths, shapes and dtypes), so a
checkpoint written by either package restores in the other. The npz is
written into a ``.tmp`` directory first and atomically renamed: a crash
mid-write never leaves a checkpoint that ``latest_step`` would pick up.

Elastic re-shard: leaves are saved whole (a DTensor leaf is gathered
first, and one rank writes), and ``restore`` places each leaf on a device,
or, given ``shardings`` and a ``DeviceMesh``, as a DTensor of that layout,
whatever layout it was saved from.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from .. import tree


def _gathered(state):
    """``state`` with each DTensor leaf gathered whole (a collective: every
    rank of its mesh calls this), and whether there were any."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(leaf, DTensor) for leaf in tree.leaves(state)):
        return state, False
    return tree.tree_map(lambda leaf: leaf.full_tensor()
                         if isinstance(leaf, DTensor) else leaf, state), True


def save(ckpt_dir: str | os.PathLike, step: int, state, keep: int = 3) -> str:
    """Write ``state`` as checkpoint ``step``. A state holding DTensors is
    saved by every rank of the default process group together: the leaves
    are gathered, rank 0 writes, and all return after it has."""
    state, distributed = _gathered(state)
    if distributed:
        import torch.distributed as dist
        path = (_write(ckpt_dir, step, state, keep)
                if dist.get_rank() == 0 else None)
        dist.barrier()
        return path or str(pathlib.Path(ckpt_dir) / f"step_{step:08d}")
    return _write(ckpt_dir, step, state, keep)


def _write(ckpt_dir, step: int, state, keep: int) -> str:
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    named = tree.leaves_with_paths(state)
    arrays = {f"leaf_{i}": np.asarray(leaf.detach().cpu().numpy())
              for i, (_, leaf) in enumerate(named)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "n_leaves": len(named),
                "paths": [p for p, _ in named],
                "shapes": [list(np.shape(a)) for a in arrays.values()],
                "dtypes": [str(np.asarray(a).dtype) for a in arrays.values()],
                "complete": True}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(base, keep)
    return str(final)


def _gc(base: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in base.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    for p in base.glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    best = None
    for p in sorted(base.glob("step_*")):
        man = p / "manifest.json"
        try:
            if json.loads(man.read_text()).get("complete"):
                best = int(p.name.split("_")[1])
        except (OSError, ValueError, json.JSONDecodeError):
            continue  # torn checkpoint: skip
    return best


def _placed(array: np.ndarray, spec, mesh):
    """``array`` as a DTensor on ``mesh``: ``spec`` is a tuple of
    placements (one per mesh dim) or a per-dimension spec
    (``dist.sharding.P``). Every rank holds the whole array, so each takes
    its own shard without communication."""
    from torch.distributed.tensor import Placement, distribute_tensor
    from ..dist.sharding import placements
    if not (len(spec) and all(isinstance(p, Placement) for p in spec)):
        spec = placements(spec, mesh)
    return distribute_tensor(torch.from_numpy(array).to(mesh.device_type),
                             mesh, spec, src_data_rank=None)


def restore(ckpt_dir: str | os.PathLike, step: int, like, device=None,
            shardings=None, mesh=None):
    """Restore into the structure of ``like`` (a tree of tensors), each
    leaf in its saved dtype on ``device``, or where ``like``'s leaf is.

    ``shardings`` (with ``mesh``, a ``DeviceMesh``): a tree of ``like``'s
    structure whose leaves are per-dimension specs or tuples of DTensor
    placements; each leaf is restored as a DTensor of that layout on the
    mesh's device type, whatever layout it was saved from."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    man = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = [z[f"leaf_{i}"] for i in range(man["n_leaves"])]
    flat_like = tree.leaves(like)
    if len(flat_like) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, "
                         f"expected {len(flat_like)}")
    if shardings is not None:
        if mesh is None:
            raise ValueError("shardings= needs the mesh they refer to")
        return tree.unflatten(like, [
            _placed(a, spec, mesh)
            for a, spec in zip(arrays, tree.leaves_up_to(like, shardings))])
    return tree.unflatten(like, [
        torch.from_numpy(a).to(l.device if device is None else device)
        for a, l in zip(arrays, flat_like)])
