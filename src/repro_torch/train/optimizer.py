"""AdamW with global-norm clipping, cosine schedule, FLOP regularization.

The port of ``repro.train.optimizer`` on the port's trees (``tree``:
nested dicts and lists of tensors). Moments are float32 whatever the
parameter dtype; ``step`` is a 0-d int32 tensor and the schedule and the
bias corrections are taken from it in float32, as the reference does.
``adamw_update`` applies the reference's per-leaf arithmetic in the same
order, one leaf at a time under ``torch.no_grad()``, and writes the new
parameters and moments into the state's own tensors: a full-width model
then needs no second copy of its parameters and moments (the reference
returns new trees, which XLA may also write in place).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "constant"


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup,
    then cosine decay to 0 at ``total_steps`` (or constant)."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def adamw_init(params) -> dict:
    """Zero float32 moments shaped like ``params`` and step 0, on the
    parameters' devices."""
    def zeros():
        return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
    dev = tree.leaves(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum over leaves (in visiting order) of each float32
    leaf's sum of squares."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree.leaves(t)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params):
    """One AdamW step. Returns (params, state, metrics) with
    ``metrics = {"grad_norm", "lr"}`` (the norm before clipping); the
    returned trees hold the tensors passed in, updated in place, and a new
    ``step``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state["m"]),
                          tree.leaves(state["v"]), tree.leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        update = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.float()                  # p itself when it is float32
        update.add_(cfg.weight_decay * pf).mul_(lr)
        p.copy_(pf.sub_(update))
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def flop_regularizer(rep: torch.Tensor) -> torch.Tensor:
    """SPLADE FLOP regularization: sum_j (mean_i |rep_ij|)^2."""
    return rep.abs().mean(dim=0).square().sum()
