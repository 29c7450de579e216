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

import torch

SOURCE = "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0                # kernel launches since reset_launches()


def _fields(table, indices, weights):
    """The stacked form: table [F, V, D], indices/weights [B, F, L]."""
    if table.dim() == 2 and indices.dim() == 2:
        return table[None], indices[:, None], weights[:, None], True
    if table.dim() == 3 and indices.dim() == 3:
        return table, indices, weights, False
    raise ValueError(f"embedding_bag: table {tuple(table.shape)} with "
                     f"indices {tuple(indices.shape)}: expected [V, D] with "
                     f"[B, L] or [F, V, D] with [B, F, L]")


def _check(table, indices, weights) -> None:
    if weights.shape != indices.shape:
        raise ValueError(f"embedding_bag: weights {tuple(weights.shape)} != "
                         f"indices {tuple(indices.shape)}")
    if indices.shape[1] != table.shape[0]:
        raise ValueError(f"embedding_bag: {indices.shape[1]} fields of "
                         f"indices, {table.shape[0]} tables")


def embedding_bag_plain(table, indices, weights) -> torch.Tensor:
    """The plain PyTorch version: for j = 0..L-1, ``out = out + row_j *
    w_j`` in the table's dtype (a port of ``ref.embedding_bag_ref`` that
    adds in the kernel's order); out-of-range slots add nothing."""
    tab, idx, w, squeeze = _fields(table, indices, weights)
    _check(tab, idx, w)
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


def embedding_bag(table, indices, weights) -> torch.Tensor:
    """Weighted bag sums: table [V, D] with indices (int32) and weights
    (the table's dtype) [B, L] -> [B, D]; or table [F, V, D] with [B, F, L]
    -> [B, F, D]. CPU tensors run the plain version; CUDA tensors launch
    the kernel (counted in the module's ``launches``)."""
    global launches
    if table.device.type == "cpu":
        return embedding_bag_plain(table, indices, weights)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    tab, idx, w, squeeze = _fields(table, indices, weights)
    _check(tab, idx, w)
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
    from . import build
    build.refuse_grad("embedding_bag", tab, w)
    n_fields, vocab, d = tab.shape
    out = torch.empty(idx.shape[:2] + (d,), dtype=tab.dtype,
                      device=tab.device)
    if out.numel():
        build.launch(SOURCE, "embedding_bag_launch", tab.device, tab, idx, w,
                     out, _DTYPES[tab.dtype], idx.shape[0] * n_fields,
                     n_fields, idx.shape[2], vocab, d)
        launches += 1
    return out[:, 0] if squeeze else out


def reset_launches() -> None:
    global launches
    launches = 0
