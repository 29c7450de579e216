"""Flash attention: GQA, causal mask at an offset, as hand-written CUDA.

``flash_attention`` [B, H, Sq, D] x [B, Hkv, Skv, D] -> [B, H, Sq, D]
replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``), which takes one sequence and is
batched by ``vmap``; here the batch is a dimension of the call. Query head
``h`` attends kv head ``h // (H // Hkv)``. With ``causal``, query row ``i``
sits at absolute position ``kv_offset + i`` and sees keys ``0 ..
kv_offset + i``; ``kv_offset`` is a runtime int (a decode step passes the
cache length). The output has q's dtype; scores, softmax and the weighted
sum are computed in float32.

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (``csrc/flash_attention.cu``) or raises.
There is no fallback. The kernel takes any strides with D contiguous, so a
caller may pass transposed views of [B, S, H, D] tensors; it needs float32
or bfloat16, D <= 128 with rows on a 16-byte boundary.

Tolerances against the plain version (which masks with -inf and
normalises before the weighted sum) are stated where they are checked:
float32 within 2e-4 (the kernel sums in another order and divides at the
end), bfloat16 within a bfloat16 rounding of the output.
"""
from __future__ import annotations

import math

import torch

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0                # kernel launches since reset_launches()


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None,
                          kv_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version (a port of ``ref.flash_attention_ref``,
    batched): float32 scores times ``sm_scale``, -inf above the causal
    diagonal, softmax, weighted sum, cast to q's dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) * sm_scale
    if causal:
        q_pos = int(kv_offset) + torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vg).to(q.dtype)


def _check(q, k, v, kv_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if k.shape[1] < 1 or h % k.shape[1] != 0:
        raise ValueError(f"flash_attention: {h} heads are not a multiple "
                         f"of {k.shape[1]} kv heads")
    if kv_offset < 0:
        raise ValueError(f"flash_attention: kv_offset={kv_offset} < 0")


def _check_cuda(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q, k, v must share one "
                         f"of {list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    d = q.shape[-1]
    vec = 16 // q.element_size()        # elements per 16-byte load
    if d > MAX_HEAD_DIM or d % vec:
        raise ValueError(f"flash_attention kernel: head dim {d} must be a "
                         f"multiple of {vec} and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if (t.stride(-1) != 1 or any(st % vec for st in strides)
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel: {name} needs D "
                             f"contiguous and rows on 16-byte boundaries")


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """Attention of q [B, H, Sq, D] over k, v [B, Hkv, Skv, D] -> [B, H, Sq,
    D] in q's dtype. ``sm_scale`` defaults to 1/sqrt(D). CPU tensors run
    the plain version; CUDA tensors launch the kernel (counted in the
    module's ``launches``). The CUDA output has q's memory layout."""
    global launches
    kv_offset = int(kv_offset)
    _check(q, k, v, kv_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda(q, k, v)
    from . import build
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)          # keeps q's layout (and alignment)
    if out.numel() == 0:
        return out
    build.launch(SOURCE, "flash_attention_launch", q.device, q, k, v, out,
                 _DTYPES[q.dtype], b, h, hkv, sq, skv, d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 int(causal), kv_offset, float(sm_scale))
    launches += 1
    return out


def reset_launches() -> None:
    global launches
    launches = 0
