"""Gradient compression with error feedback.

The port of ``repro.dist.compression`` on the port's trees. Per leaf, the
error-corrected gradient ``g + err`` is split into (1) its top-k
largest-magnitude coordinates, transmitted exactly in float32 (value +
index), and (2) the remainder, transmitted as per-tensor-scaled int8. The
new error-feedback state is exactly the int8 quantization residual, so it
is bounded by ``scale / 2`` at every step and the cumulative transmitted
update tracks the cumulative true gradient to within one quantization
step.

Top-k ties go to the lower index, as ``lax.top_k``'s (a stable sort;
``torch.topk`` on CUDA is not stable); rounding is half to even, as
``jnp.round``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree
from ..core.traversal import _topk_stable


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    topk_fraction: float = 1.0 / 64.0   # exact-fp32 heavy hitters per leaf
    residual_bits: int = 8              # quantized tail precision
    index_bits: int = 32                # accounting: bits per top-k index


DEFAULT = CompressionConfig()


def _leaf_k(n: int, cfg: CompressionConfig) -> int:
    return max(1, int(n * cfg.topk_fraction))


def init_error_feedback(params):
    """Zero float32 error accumulators shaped like the gradient tree."""
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def topk_sparsify(g: torch.Tensor, k: int) -> torch.Tensor:
    """Dense tensor with everything but the k largest-|.| entries zeroed."""
    flat = g.reshape(-1).float()
    _, idx = _topk_stable(flat.abs(), k)
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    return (flat * mask).reshape(g.shape).to(g.dtype)


def _compress_leaf(g, err, cfg: CompressionConfig):
    flat = g.reshape(-1).float() + err.reshape(-1)
    exact = topk_sparsify(flat, _leaf_k(flat.numel(), cfg))
    rest = flat - exact
    qmax = float(2 ** (cfg.residual_bits - 1) - 1)
    scale = torch.clamp_min(rest.abs().max() / qmax, 1e-12)
    quant = torch.round(rest / scale) * scale
    sent = (exact + quant).to(g.dtype)       # what is actually transmitted
    # fed back against the cast value, so that low-precision rounding
    # (bf16 gradients) is corrected too
    new_err = flat - sent.float()
    return sent.reshape(g.shape), new_err.reshape(g.shape)


def compress_with_feedback(grads, err, cfg: CompressionConfig = DEFAULT):
    """Returns (transmitted_grads, new_error_feedback), trees of
    ``grads``' structure."""
    pairs = [_compress_leaf(g, e, cfg)
             for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(grads, [p[1] for p in pairs]))


def compression_ratio(grads, cfg: CompressionConfig = DEFAULT) -> float:
    """Dense fp32 bits / transmitted bits for one gradient tree.

    Transmitted per leaf: k fp32 values + k indices + (n - k) int8 residual
    entries + one fp32 scale.
    """
    dense_bits = 0
    sent_bits = 0
    for leaf in tree.leaves(grads):
        n = math.prod(leaf.shape) if leaf.shape else 1
        k = _leaf_k(n, cfg)
        dense_bits += n * 32
        sent_bits += (k * (32 + cfg.index_bits)
                      + (n - k) * cfg.residual_bits + 32)
    return dense_bits / max(sent_bits, 1)
