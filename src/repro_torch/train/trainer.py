"""Fault-tolerant trainer: microbatch accumulation, atomic checkpoints,
auto-resume, deterministic data order, optional gradient compression.

The port of ``repro.train.trainer``; the step runs eagerly where the
reference's is ``jax.jit``-compiled. The data pipeline is keyed by step
number (``data_fn(step) -> batch``), so a restart replays exactly the
batches that were never applied; with atomic checkpoints this gives
effectively-once batch semantics. ``fail_at_step`` injects a crash (the
resume path is tested with it). ``init_params`` is a function of an int
seed, as ``launch.steps.init_fn`` returns; the parameters, and with them
the whole state, live on the device it draws them on.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Callable

import torch

from .. import tree
from ..core.index import check_full_f32
from ..dist.compression import (compress_with_feedback, compression_ratio,
                                init_error_feedback)
from . import checkpoint
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_keep: int = 3
    out_dir: str = "runs/default"
    log_every: int = 10
    grad_compression: bool = False
    fail_at_step: int | None = None    # fault injection (tests)


class SimulatedFailure(RuntimeError):
    pass


def _param_layout(grad, param):
    """A DTensor gradient laid out as its parameter (a partial sum over the
    data-parallel ranks becomes a reduce-scatter or an all-reduce there),
    the reference's ``grad_shardings``; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(grad, DTensor) and grad.placements != param.placements:
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def train_step(loss_fn: Callable, opt_cfg: AdamWConfig, state: dict, batch,
               microbatches: int = 1, compression: bool = False):
    """One optimizer step on ``batch``: (state, metrics) with ``loss``,
    ``grad_norm``, ``lr`` (and ``err_norm`` under compression). With m
    microbatches the batch's leading dims are split in m, the gradients
    are summed from float32 zeros in microbatch order and divided by m, as
    the reference's scan does. The state's tensors are updated in place
    (``adamw_update``)."""
    params = state["params"]
    dev = tree.leaves(params)[0].device
    check_full_f32(dev, "a train step")
    m = microbatches
    if m > 1:
        gsum = tree.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(m):
            mb = tree.tree_map(
                lambda x: x.reshape((m, x.shape[0] // m) + x.shape[1:])[i],
                batch)
            loss, g = tree.value_and_grad(loss_fn, params, mb)
            gsum = tree.tree_map(torch.add, gsum, g)
            lsum = lsum + loss
        grads = tree.tree_map(lambda g: g / m, gsum)
        loss = lsum / m
    else:
        loss, grads = tree.value_and_grad(loss_fn, params, batch)
    grads = tree.tree_map(_param_layout, grads, params)
    if compression:
        grads, err = compress_with_feedback(grads, state["err"])
    params, opt, metrics = adamw_update(opt_cfg, grads, state["opt"], params)
    new_state = {"params": params, "opt": opt}
    if compression:
        new_state["err"] = err
        metrics["err_norm"] = global_norm(err)
    metrics["loss"] = loss
    return new_state, metrics


class Trainer:
    def __init__(self, loss_fn: Callable, init_params: Callable,
                 data_fn: Callable, cfg: TrainerConfig,
                 opt_cfg: AdamWConfig | None = None):
        self.loss_fn = loss_fn
        self.data_fn = data_fn
        self.cfg = cfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=cfg.total_steps)
        self.out = pathlib.Path(cfg.out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self._init_params = init_params

    # -- lifecycle ----------------------------------------------------------

    def init_state(self, seed: int = 0):
        params = self._init_params(seed)
        state = {"params": params, "opt": adamw_init(params)}
        if self.cfg.grad_compression:
            state["err"] = init_error_feedback(params)
        return state

    def run(self, seed: int = 0) -> dict:
        ckpt_dir = self.out / "ckpt"
        start = checkpoint.latest_step(ckpt_dir)
        state = self.init_state(seed)
        start_step = 0
        if start is not None:
            state = checkpoint.restore(ckpt_dir, start, state)
            start_step = start
        log_path = self.out / "metrics.jsonl"
        # shape-only constant (grads are param-shaped by construction)
        comp_ratio = (round(compression_ratio(state["params"]), 2)
                      if self.cfg.grad_compression else None)
        losses = []
        with log_path.open("a") as log:
            for step in range(start_step, self.cfg.total_steps):
                if self.cfg.fail_at_step is not None \
                        and step == self.cfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at {step}")
                t0 = time.perf_counter()
                batch = self.data_fn(step)
                state, metrics = train_step(
                    self.loss_fn, self.opt_cfg, state, batch,
                    self.cfg.microbatches, self.cfg.grad_compression)
                loss = float(metrics["loss"])
                losses.append(loss)
                if step % self.cfg.log_every == 0 \
                        or step == self.cfg.total_steps - 1:
                    rec = {"step": step, "loss": loss,
                           "grad_norm": float(metrics["grad_norm"]),
                           "lr": float(metrics["lr"]),
                           "sec": time.perf_counter() - t0}
                    if "err_norm" in metrics:
                        rec["err_norm"] = float(metrics["err_norm"])
                        rec["compression_ratio"] = comp_ratio
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                next_step = step + 1
                if next_step % self.cfg.ckpt_every == 0 \
                        or next_step == self.cfg.total_steps:
                    checkpoint.save(ckpt_dir, next_step, state,
                                    self.cfg.ckpt_keep)
        return {"state": state, "losses": losses,
                "final_step": self.cfg.total_steps}
