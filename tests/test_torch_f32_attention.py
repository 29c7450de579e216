"""The arithmetic of K6's "f32" route, on the CPU.

``csrc/flash_attention_f32.cu`` computes every product of S = Q K^T and
of P V on the tensor cores from TF32 operands, three times (3xTF32): each
operand is split as x = hi + lo, hi = x rounded to TF32 (10 mantissa
bits, to nearest, ties away from zero: ``cvt.rna``) and lo = the rest
rounded the same way, and the product is lo*hi + hi*lo + hi*hi in
float32. It runs an online softmax over key tiles with P kept in float32.
A CUDA kernel cannot run here, so this file emulates that arithmetic in
plain torch (``emulate_f32_route``: the same splits and products, in the
kernel's key order: 64-key tiles at prefill, 32 at D > 64, and at decode
8 warps' slices joined at the end) and holds it against the JAX package's
Pallas kernel in float32, called as the reference's tests call it on the
CPU (interpret mode), within the route's unchanged bound ``fa.tolerance``
(2e-4 + 2e-4 |ref|), where a zeroed output fails, and within
``fa.three_pass_bound`` (a tenth of it), which the same emulation with
one TF32 pass per product fails at every shape. Inputs are made with
numpy from a seed.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 on its bit pattern: to nearest with ties
    away from zero at the 13th bit, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: lo hi + hi lo + hi hi, each product
    of TF32 operands exact in float32, summed in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 pass (what the route must not be)."""
    return tf32(a) @ tf32(b)


def _online(q, kg, vg, keys, pos, causal, scale, mm):
    """(m, l, acc) of an online softmax over the key ranges ``keys`` in
    turn: scores in log2 units, running max m (0 in place of -inf), l
    summed from the float32 P, the P V product from the same P."""
    h, sq, d = q.shape
    m = torch.full((h, sq), -math.inf, dtype=q.dtype)
    l = torch.zeros(h, sq, dtype=q.dtype)
    acc = torch.zeros(h, sq, d, dtype=q.dtype)
    for k0, k1 in keys:
        s = mm(q, kg[:, k0:k1].transpose(1, 2)) * scale
        if causal:
            key = torch.arange(k0, k1)
            s = s.masked_fill(key[None, None, :] > pos[None, :, None],
                              -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p, vg[:, k0:k1])
        m = m_new
    return m, l, acc


def emulate_f32_route(q, k, v, *, causal, kv_offset, mm=None):
    """The "f32" kernel's arithmetic for one sequence: q [H, Sq, D], k, v
    [Hkv, Skv, D] float32, products by ``mm`` (3xTF32 unless given), in
    the kernel's key order. Prefill (more than 16 rows per kv head): one
    online softmax over 64-key tiles (32 at D > 64). Decode: 8 warps take
    the slices w, w + 8, ... of 24 keys (8 at D > 64), each with its own
    (m, l, acc), joined as the kernel joins them: m = max m_w, l = sum
    l_w 2^(m_w - m), out = sum acc_w 2^(m_w - m) / max(l, 1e-30)."""
    mm = mm or mm_3xtf32
    h, sq, d = q.shape
    hkv, skv = k.shape[0], k.shape[1]
    group = h // hkv
    kg = k.repeat_interleave(group, 0)
    vg = v.repeat_interleave(group, 0)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype) * LOG2E
    pos = kv_offset + torch.arange(sq)
    run = functools.partial(_online, q, kg, vg, pos=pos, causal=causal,
                            scale=scale, mm=mm)
    if group * sq > 16:
        tile = 64 if d <= 64 else 32
        m, l, acc = run([(k0, min(k0 + tile, skv))
                         for k0 in range(0, skv, tile)])
        return acc / l.clamp_min(1e-30)[..., None]
    warps, width = 8, (24 if d <= 64 else 8)
    parts = [run([(k0, min(k0 + width, skv))
                  for k0 in range(w * width, skv, warps * width)])
             for w in range(warps)]
    m = torch.stack([p[0] for p in parts]).amax(0)
    mu = torch.where(m == -math.inf, 0.0, m)
    wt = [torch.exp2(p[0] - mu) for p in parts]
    l = sum(p[1] * w for p, w in zip(parts, wt))
    acc = sum(p[2] * w[..., None] for p, w in zip(parts, wt))
    return acc / l.clamp_min(1e-30)[..., None]


# h, hkv, sq, skv, d, causal, kv_offset, and the Pallas blocks (each must
# divide its length)
SHAPES = [
    (8, 2, 1, 130, 64, True, 129, 1, 65),      # a decode row, group 4
    (4, 2, 100, 100, 48, True, 0, 50, 50),     # ragged causal prefill
    (2, 2, 48, 160, 32, False, 0, 48, 32),     # bidirectional
    (8, 8, 3, 500, 128, True, 497, 3, 100),    # D 128 at a long offset
    (8, 2, 128, 128, 64, True, 0, 64, 64),     # lm_f32's prefill, group 4
]


def _inputs(seed, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((h, sq, d), (hkv, skv, d), (hkv, skv, d))]


@functools.lru_cache(maxsize=None)
def _case(h, hkv, sq, skv, d, causal, off, bq, bk):
    """q, k, v and the Pallas kernel's float32 output on them."""
    arrs = _inputs(h * 1000 + skv, h, hkv, sq, skv, d)
    pallas = torch.from_numpy(np.array(jax_flash(
        *(jnp.asarray(a) for a in arrs), causal=causal, kv_offset=off,
        block_q=bq, block_k=bk), np.float32))
    return (*(torch.from_numpy(a) for a in arrs), pallas)


@pytest.mark.parametrize("h,hkv,sq,skv,d,causal,off,bq,bk", SHAPES)
def test_3xtf32_emulation_within_f32_bound_of_pallas(h, hkv, sq, skv, d,
                                                      causal, off, bq, bk):
    """The emulated route lies within 2e-4 + 2e-4 |ref| of the Pallas
    kernel's float32 output, and within the tenth of it that
    ``fa.three_pass_bound`` holds the card's kernel to; a zeroed output
    does not."""
    q, k, v, pallas = _case(h, hkv, sq, skv, d, causal, off, bq, bk)
    bound = fa.tolerance(q[None], k[None], v[None], pallas[None], "f32",
                         causal=causal, kv_offset=off)[0]
    assert torch.equal(bound, 2e-4 + 2e-4 * pallas.abs())
    out = emulate_f32_route(q, k, v, causal=causal, kv_offset=off)
    diff = (out - pallas).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    tight = fa.three_pass_bound(pallas)
    assert bool((diff <= tight).all()), float((diff - tight).max())
    assert not bool((pallas.abs() <= bound).all())          # zeros fail


@pytest.mark.parametrize("h,hkv,sq,skv,d,causal,off,bq,bk", SHAPES)
def test_one_tf32_pass_fails_three_pass_bound(h, hkv, sq, skv, d, causal,
                                              off, bq, bk):
    """The control: the same route with one TF32 pass per product (hi hi
    only) falls outside ``fa.three_pass_bound`` of the Pallas kernel on
    at least one element at every shape, at the decode row too, where it
    can stay inside the float32 tolerance."""
    q, k, v, pallas = _case(h, hkv, sq, skv, d, causal, off, bq, bk)
    out = emulate_f32_route(q, k, v, causal=causal, kv_offset=off,
                            mm=mm_1xtf32)
    assert bool(torch.isfinite(out).all())
    assert not bool(((out - pallas).abs() <= fa.three_pass_bound(pallas))
                    .all())


def test_decode_emulation_joins_warp_slices():
    """The decode emulation's slice-and-join order gives the one-pass
    softmax: with exact float64 products it matches plain attention to
    float64 rounding, over 130 keys (six 24-key slices and a 10-key one
    over 8 warps, one idle) and at D 128 (8-key slices)."""
    for d, skv in ((64, 130), (128, 61)):
        arrs = _inputs(d + skv, 8, 2, 1, skv, d)
        q, k, v = (torch.from_numpy(a).double() for a in arrs)
        out = emulate_f32_route(q, k, v, causal=True, kv_offset=skv - 1,
                                mm=torch.matmul)
        s = q @ k.repeat_interleave(4, 0).transpose(1, 2) / math.sqrt(d)
        ref = torch.softmax(s, -1) @ v.repeat_interleave(4, 0)
        torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi has 10 mantissa bits (low 13 bits zero), rounds a tie away from
    zero, and hi + lo gives x back to within 2^-21 |x|."""
    one_ulp = 2.0 ** -10                      # TF32 spacing at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 4, 3.0, 0.0], dtype=torch.float32)
    hi, lo = split(x)
    assert hi.tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 3.0, 0.0]
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(10000).astype(np.float32)
                         * np.float32(1e3))
    hi, lo = split(y)
    assert bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    err = ((hi.double() + lo.double()) - y.double()).abs()
    assert bool((err <= 2.0 ** -21 * y.double().abs()).all())


def test_3xtf32_products_near_float32():
    """A 3xTF32 matrix product stays within 2^-19 of the float64 product
    scaled by |a| @ |b|, where one TF32 pass is off by far more."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((mm_3xtf32(a, b).double() - exact).abs() / scale).max()
    err1 = ((mm_1xtf32(a, b).double() - exact).abs() / scale).max()
    assert err3 <= 2.0 ** -19
    assert err1 > 2.0 ** -13
