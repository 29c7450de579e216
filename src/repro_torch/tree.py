"""Trees of tensors: the port's parameter and train-state trees.

A tree is nested dicts and lists (or tuples) with tensors, or other
values, at the leaves, as the models' parameters are. Leaves are visited
in the order of ``jax.tree_util``: dict keys sorted, sequences in order;
a leaf's path is written as ``jax.tree_util.keystr`` writes it
(``['opt']['m']['w']``, ``['layers'][0]``), so a checkpoint's manifest
reads the same in both packages. ``value_and_grad`` is the gradient of a
loss over such a tree.
"""
from __future__ import annotations

from typing import Callable

import torch


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in visiting order."""
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in leaves_with_paths(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, sub in enumerate(tree)
                for pl in leaves_with_paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_up_to(like, sub) -> list:
    """The subtrees of ``sub`` (a tree of ``like``'s structure down to
    ``like``'s leaves, which may hold tuples there, as specs) at the
    places of ``like``'s leaves, in visiting order."""
    if isinstance(like, dict):
        return [x for key in sorted(like)
                for x in leaves_up_to(like[key], sub[key])]
    if isinstance(like, (list, tuple)):
        if len(like) != len(sub):
            raise ValueError("trees of different structure")
        return [x for a, b in zip(like, sub) for x in leaves_up_to(a, b)]
    return [sub]


def unflatten(like, new_leaves) -> object:
    """A tree of ``like``'s structure holding ``new_leaves`` in visiting
    order; raises unless their number is ``like``'s."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {key: build(t[key]) for key in sorted(t)}
            return {key: out[key] for key in t}      # keep the caller's order
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``, a scalar tensor, as
    ``jax.value_and_grad``: the loss detached, the gradients a tree of
    ``params``' structure (zeros for a leaf the loss does not use). The
    parameters are differentiated through detached views of themselves,
    so the caller's tensors are untouched and gather no ``.grad``."""
    flat = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)
