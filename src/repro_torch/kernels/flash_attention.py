"""Flash attention: GQA, causal mask at an offset, as hand-written CUDA.

``flash_attention`` [B, H, Sq, D] x [B, Hkv, Skv, D] -> [B, H, Sq, D]
replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``), which takes one sequence and is
batched by ``vmap``; here the batch is a dimension of the call. Query head
``h`` attends kv head ``h // (H // Hkv)``. With ``causal``, query row ``i``
sits at absolute position ``kv_offset + i`` and sees keys ``0 ..
kv_offset + i``; ``kv_offset`` is a runtime int (a decode step passes the
cache length). The output has q's dtype; scores and softmax are computed
in float32, and the weighted sum accumulates in float32.

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches a kernel or raises. There is no fallback. Three
routes, chosen by ``route(q, k)`` from shape and dtype alone:

- "split" (``csrc/flash_attention_split.cu``): bfloat16 with at most 16
  query rows per kv head (group * Sq): a decode step. The keys are split
  over ``n_split`` blocks per kv head (``split_plan``), each writing a
  float32 partial (m, l, acc) to scratch, and a second kernel joins them:
  two device launches per call.
- "mma" (``csrc/flash_attention_mma.cu``): every other bfloat16 call, on
  the tensor cores (mma.sync, a two-stage cp.async K/V ring): prefill, a
  cache-free forward, an encoder, a short prompt.
- "f32" (``csrc/flash_attention_f32.cu``): every float32 call, on the
  tensor cores at float32 accuracy (three TF32 products per product); at
  most 16 rows per kv head, the block's warps split the keys.

"split" and "mma" round the unnormalized weights P to bfloat16 before the
P V product and take l from the unrounded P, as the TPU kernel does; "f32"
keeps P in float32, as the TPU kernel does at float32. All take any
strides with D contiguous, so a caller may pass transposed views of [B,
S, H, D] tensors; they need float32 or bfloat16, D <= 128 a multiple of
16 bytes, rows on a 16-byte boundary. ``tolerance`` gives each route's
per-element bound against the plain version.
"""
from __future__ import annotations

import functools
import math

import torch

SOURCES = {"mma": "flash_attention_mma.cu",
           "split": "flash_attention_split.cu",
           "f32": "flash_attention_f32.cu"}
ROUTES = tuple(SOURCES)                            # what route() returns
# the bounds ``tolerance`` knows: each route's, and "unrounded", that of a
# kernel keeping P in float32 (no route does in bfloat16)
BOUNDS = ROUTES + ("unrounded",)
MAX_HEAD_DIM = 128
SPLIT_MAX_ROWS = 16         # query rows per kv head a split block holds
SPLIT_TILE_KEYS = 64        # keys per tile of the split kernel
_DTYPES = (torch.float32, torch.bfloat16)     # what the kernels take
launches = 0                # flash_attention calls on the card since reset
launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None, kv_offset: int = 0,
                          round_p: bool = False) -> torch.Tensor:
    """The plain PyTorch version (a port of ``ref.flash_attention_ref``,
    batched): float32 scores times ``sm_scale``, -inf above the causal
    diagonal, softmax, weighted sum, cast to q's dtype. With ``round_p``
    the normalized weights are rounded to v's dtype before the weighted
    sum, as the reference model's attention does (``p.astype(v.dtype)``;
    the identity for float32 v)."""
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
    if round_p:
        p = p.to(v.dtype).float()
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


def route(q, k) -> str:
    """The kernel a CUDA call of these shapes and dtype launches: float32
    "f32"; bfloat16 "split" at <= 16 query rows per kv head (group * Sq),
    "mma" above. Raises for a head dim no kernel takes (above 128, or not
    a multiple of 16 bytes)."""
    d = q.shape[-1]
    vec = 16 // q.element_size()        # elements per 16-byte load
    if d > MAX_HEAD_DIM or d % vec:
        raise ValueError(f"flash_attention kernel: head dim {d} must be a "
                         f"multiple of {vec} and at most {MAX_HEAD_DIM}")
    if q.dtype != torch.bfloat16:
        return "f32"
    rows = q.shape[1] // k.shape[1] * q.shape[2]
    return "split" if rows <= SPLIT_MAX_ROWS else "mma"


def split_plan(batch: int, hkv: int, n_keys: int, n_sm: int) -> tuple:
    """(n_split, split_keys) of the "split" kernel for ``n_keys`` visible
    keys: the fewest splits that give at least 2 blocks per SM over the
    batch * hkv kv heads, no more than there are 64-key tiles, each split
    an equal whole number of tiles (the last may be shorter)."""
    tiles = -(-n_keys // SPLIT_TILE_KEYS)
    if tiles == 0:
        return 1, SPLIT_TILE_KEYS
    want = min(tiles, -(-2 * n_sm // (batch * hkv)))
    per = -(-tiles // want)
    return -(-tiles // per), per * SPLIT_TILE_KEYS


def tolerance(q, k, v, ref, route, **kw) -> torch.Tensor:
    """Per-element bound on |kernel - plain| for ``route``'s kernel (one of
    ``BOUNDS``), where ``ref`` is ``flash_attention_plain(q, k, v, **kw)``.

    - float32 (every route): 2e-4 + 2e-4 |ref|. The kernel sums in
      another order, divides at the end and uses the fast exponential;
      "f32" also forms each product from three TF32 products (hi hi + hi
      lo + lo hi of x = hi + lo), which leaves about 2^-21 of it out.
    - bfloat16, "unrounded" (a kernel that keeps P in float32):
      1e-2 |ref| + 1e-4 (p @ |v|). Each side rounds a
      float32 value to bfloat16 once, so they are at most 2^-7 |x| apart;
      1e-4 is the float32 error before that rounding, scaled by the row's
      weighted mean of |v| (``p @ |v|``, the plain version on |v|). A fixed
      floor would pass a zeroed output of a long average, whose elements
      are small.
    - bfloat16, "mma" and "split": 1e-2 |ref| + (2^-8 + 1e-4) (p @ |v|).
      The kernel also rounds each weight p_j to bfloat16 before the P V
      product (as the TPU kernel does), which moves it by at most
      2^-8 p_j, while the row sum l is taken from the unrounded p. The
      output sum_j p_j v_j / l so moves by at most 2^-8 sum_j p_j |v_j| /
      l = 2^-8 (p @ |v|). "split" rounds each p_j against its split's
      running max and rescales the split's sums by e^(m_s - m) in float32,
      which scales the rounded term and its error alike: the same bound.
    """
    if route not in BOUNDS:
        raise ValueError(f"flash_attention: unknown route {route!r}")
    if ref.dtype == torch.float32:
        return 2e-4 + 2e-4 * ref.abs()
    mag = flash_attention_plain(q, k, v.abs(), **kw).float()
    weight = 1e-4 + (2.0 ** -8 if route in ("mma", "split") else 0.0)
    return 1e-2 * ref.float().abs() + weight * mag


def three_pass_bound(ref) -> torch.Tensor:
    """A tighter per-element bound for the "f32" route: 2e-5 + 2e-5 |ref|,
    a tenth of ``tolerance``'s float32 bound, where ``ref`` is the float32
    plain output. Three TF32 products per product leave about 2^-21 of
    each out and stay far inside it; one TF32 pass leaves 2^-11 out and
    falls outside it, though at a decode row it can stay inside
    ``tolerance``. It holds the kernel to its pass structure."""
    return 2e-5 + 2e-5 * ref.abs()


def _check_cuda(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q, k, v must share one "
                         f"of {list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    route(q, k)                         # raises for a head dim it refuses
    vec = 16 // q.element_size()        # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if (t.stride(-1) != 1 or any(st % vec for st in strides)
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel: {name} needs D "
                             f"contiguous and rows on 16-byte boundaries")


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, kv_offset: int = 0,
                    round_p: bool = False) -> torch.Tensor:
    """Attention of q [B, H, Sq, D] over k, v [B, Hkv, Skv, D] -> [B, H, Sq,
    D] in q's dtype. ``sm_scale`` defaults to 1/sqrt(D). CPU tensors run
    the plain version (``round_p`` passes to it); CUDA tensors launch
    ``route(q, k)``'s kernel (counted in the module's ``launches`` and
    ``launches_by_route``), which rounds P as its route does whatever
    ``round_p`` says. The CUDA output has q's memory layout."""
    global launches
    kv_offset = int(kv_offset)
    _check(q, k, v, kv_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, kv_offset=kv_offset,
                                     round_p=round_p)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    out = torch.empty_like(q)          # keeps q's layout (and alignment)
    if out.numel() == 0:
        return out
    way = route(q, k)
    _launch(way, q, k, v, out, causal, float(sm_scale), kv_offset)
    launches += 1
    launches_by_route[way] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(way, q, k, v, out, causal, sm_scale, kv_offset) -> None:
    """Launch route ``way``'s kernel into ``out`` (checked CUDA tensors),
    uncounted: ``flash_attention`` counts its own calls."""
    from . import build
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    geometry = (b, h, hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], int(causal), kv_offset,
                sm_scale)
    if way == "split":
        n_keys = min(skv, kv_offset + sq) if causal else skv
        n_split, split_keys = split_plan(b, hkv, n_keys,
                                         _sm_count(q.device))
        # float32 partials: m and l [n_split, B*H*Sq], acc [.., D]
        scratch = torch.empty(n_split * b * h * sq * (d + 2),
                              dtype=torch.float32, device=q.device)
        build.launch(SOURCES[way], "flash_attention_split_launch", q.device,
                     q, k, v, out, scratch, *geometry, n_split, split_keys)
    else:
        build.launch(SOURCES[way], f"flash_attention_{way}_launch", q.device,
                     q, k, v, out, *geometry)


def reset_launches() -> None:
    global launches
    launches = 0
    for way in launches_by_route:
        launches_by_route[way] = 0
