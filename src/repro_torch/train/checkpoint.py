"""Fault-tolerant checkpointing: atomic, keep-N, auto-resume.

The port of ``repro.train.checkpoint``, with its on-disk layout:
``<dir>/step_<n>/arrays.npz`` (``leaf_<i>`` for the i-th leaf in visiting
order: dict keys sorted, lists in order) and ``manifest.json`` (the
leaves' ``jax.tree_util.keystr`` paths, shapes and dtypes), so a
checkpoint written by either package restores in the other. The npz is
written into a ``.tmp`` directory first and atomically renamed: a crash
mid-write never leaves a checkpoint that ``latest_step`` would pick up.
``restore`` places each leaf on a device; the reference's elastic
re-shard onto a mesh (``shardings=``) is not ported.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from .. import tree


def save(ckpt_dir: str | os.PathLike, step: int, state, keep: int = 3) -> str:
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


def restore(ckpt_dir: str | os.PathLike, step: int, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors), each
    leaf in its saved dtype on ``device``, or where ``like``'s leaf is."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    man = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = [z[f"leaf_{i}"] for i in range(man["n_leaves"])]
    flat_like = tree.leaves(like)
    if len(flat_like) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, "
                         f"expected {len(flat_like)}")
    return tree.unflatten(like, [
        torch.from_numpy(a).to(l.device if device is None else device)
        for a, l in zip(arrays, flat_like)])
