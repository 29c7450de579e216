"""Embedding bag: gather and weighted sum, as hand-written CUDA.

``embedding_bag`` replaces the TPU kernel ``repro/kernels/embedding_bag.py::
embedding_bag`` (body ``_kernel``): ``out[b] = sum_j w[b, j] *
table[idx[b, j]]``, added in j order into an accumulator of the table's
dtype, as the Pallas ``fori_loop`` adds into its output block. Padding is
a weight-0 slot. Besides a [V, D] table with [B, L] indices, it takes the
fields of a model stacked: a [F, V, D] table with [B, F, L] indices gives
[B, F, D] in one launch (bag (b, f) reads table f).

An index outside [0, V) adds nothing to its bag, in the kernel and in the
plain version alike (the TPU kernel assumes every index is in range).

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (``csrc/embedding_bag.cu``) or raises.
There is no fallback. The kernel has no backward: a CUDA call in grad mode
on a table or weights that require grad raises (``build.refuse_grad``);
training differentiates through ``sparse_ops.gather_embedding_bag``. The kernel is bit-equal to the plain version: both
round each product and each sum to the table's dtype, in the same order.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

SOURCE = "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0                # kernel launches since reset_launches()


def _check(table, indices, weights) -> None:
    """The shapes the op takes ([V, D] with [B, L], or [F, V, D] with [B, F,
    L]; weights as indices), read without making a view."""
    if not ((table.dim() == 2 and indices.dim() == 2)
            or (table.dim() == 3 and indices.dim() == 3)):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} with "
                         f"indices {tuple(indices.shape)}: expected [V, D] "
                         f"with [B, L] or [F, V, D] with [B, F, L]")
    if weights.shape != indices.shape:
        raise ValueError(f"embedding_bag: weights {tuple(weights.shape)} != "
                         f"indices {tuple(indices.shape)}")
    if table.dim() == 3 and indices.shape[1] != table.shape[0]:
        raise ValueError(f"embedding_bag: {indices.shape[1]} fields of "
                         f"indices, {table.shape[0]} tables")


def _fields(table, indices, weights):
    """The stacked form: table [F, V, D], indices/weights [B, F, L]."""
    if table.dim() == 2:
        return table[None], indices[:, None], weights[:, None], True
    return table, indices, weights, False


def embedding_bag_plain(table, indices, weights) -> torch.Tensor:
    """The plain PyTorch version: for j = 0..L-1, ``out = out + row_j *
    w_j`` in the table's dtype (a port of ``ref.embedding_bag_ref`` that
    adds in the kernel's order); out-of-range slots add nothing."""
    _check(table, indices, weights)
    tab, idx, w, squeeze = _fields(table, indices, weights)
    n_fields, vocab, d = tab.shape
    valid = (idx >= 0) & (idx < vocab)
    safe = torch.where(valid, idx, 0).long()
    field = torch.arange(n_fields, device=tab.device)[None, :]
    out = torch.zeros(idx.shape[:2] + (d,), dtype=tab.dtype,
                      device=tab.device)
    for j in range(idx.shape[2]):
        row = tab[field, safe[..., j]]
        out = torch.where(valid[..., j, None],
                          out + row * w[..., j, None].to(tab.dtype), out)
    return out[:, 0] if squeeze else out


def _check_cuda(tab, idx, w) -> None:
    """What the kernel needs of CUDA inputs, read from dtypes, devices and
    strides (a fake tensor will do)."""
    if tab.dtype not in _DTYPES or w.dtype != tab.dtype:
        raise ValueError(f"embedding_bag kernel: table and weights must "
                         f"share one of {list(_DTYPES)}, got {tab.dtype}, "
                         f"{w.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"embedding_bag kernel: indices must be int32, got "
                         f"{idx.dtype}")
    for name, t in (("table", tab), ("indices", idx), ("weights", w)):
        if t.device != tab.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{tab.device}")
        if not t.is_contiguous():
            raise ValueError(f"embedding_bag kernel: {name} must be "
                             f"contiguous")


def _out_shape(table, indices) -> tuple:
    return tuple(indices.shape[:-1]) + (table.shape[-1],)


def embedding_bag(table, indices, weights) -> torch.Tensor:
    """Weighted bag sums: table [V, D] with indices (int32) and weights
    (the table's dtype) [B, L] -> [B, D]; or table [F, V, D] with [B, F, L]
    -> [B, F, D]. CPU tensors run the plain version; CUDA tensors launch
    the kernel (counted in the module's ``launches``).

    The call goes through the torch op
    ``torch.ops.repro_torch.embedding_bag``: a fake tensor gets an empty
    output (``register_fake``), ``FlopCounterMode`` counts ``flops`` of
    it, and DTensors are sharded by ``_sharding`` (the bags split, the
    table whole; ``sparse_ops.embedding_bag`` reads a table split on its
    rows where each row lives instead). A CPU call that autograd records
    runs the plain version outside the op; on the card such a call raises
    (``build.refuse_grad``)."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if table.device.type == "cpu":
        if torch.is_grad_enabled() and (table.requires_grad
                                        or weights.requires_grad):
            return embedding_bag_plain(table, indices, weights)
    else:
        from . import build
        build.refuse_grad("embedding_bag", table, weights)
    return torch.ops.repro_torch.embedding_bag(table, indices, weights)


def _op(table, indices, weights) -> torch.Tensor:
    """The op behind ``embedding_bag``: the plain version on CPU tensors, a
    kernel launch on CUDA tensors."""
    global launches
    out = torch.empty(_out_shape(table, indices), dtype=table.dtype,
                      device=table.device)
    if table.device.type == "cpu":
        return out.copy_(embedding_bag_plain(table, indices, weights))
    _check(table, indices, weights)
    _check_cuda(table, indices, weights)
    tab, idx, w, _ = _fields(table, indices, weights)
    n_fields, vocab, d = tab.shape
    if out.numel():
        from . import build
        build.launch(SOURCE, "embedding_bag_launch", tab.device, tab, idx, w,
                     out, _DTYPES[tab.dtype], idx.shape[0] * n_fields,
                     n_fields, idx.shape[2], vocab, d)
        launches += 1
    return out


# Defined through torch.library.Library, as K6 (``flash_attention._LIB``):
# a call goes straight from the dispatcher to ``_op``.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("embedding_bag(Tensor table, Tensor indices, Tensor weights) "
            "-> Tensor")
_LIB.impl("embedding_bag", _op, "CPU")
_LIB.impl("embedding_bag", _op, "CUDA")


@torch.library.register_fake("repro_torch::embedding_bag", lib=_LIB)
def _fake(table, indices, weights):
    """The checks of a real call that read no data, and an empty output."""
    _check(table, indices, weights)
    if table.device.type == "cuda":
        _check_cuda(table, indices, weights)
    return torch.empty(_out_shape(table, indices), dtype=table.dtype,
                       device=table.device)


def flops(table_shape, indices_shape) -> int:
    """The arithmetic of one call: a multiply and an add of D elements per
    (bag, index) pair, padding slots included."""
    return 2 * table_shape[-1] * math.prod(indices_shape)


@register_flop_formula(torch.ops.repro_torch.embedding_bag)
def _flop_formula(table_shape, indices_shape, weights_shape, *args,
                  out_shape=None, **kwargs) -> int:
    return flops(table_shape, indices_shape)


@register_sharding(torch.ops.repro_torch.embedding_bag.default)
def _sharding(table, indices, weights):
    """DTensor strategies, one mesh dim at a time: all replicated, or the
    bags split (indices, weights and the output on dim 0) over a whole
    table. A table split on its rows takes ``_bag_split_rows`` instead."""
    return [([Replicate()], [Replicate()] * 3),
            ([Shard(0)], [Replicate(), Shard(0), Shard(0)])]


def reset_launches() -> None:
    global launches
    launches = 0
