"""The flash-attention kernel's plain PyTorch version against the Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and the
reference's oracle ``ref.flash_attention_ref``.

The port's wrapper runs the plain version on CPU tensors, which is what
these tests reach; the CUDA kernel is held to the same plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerance: float32
within rtol/atol 2e-4, the bound tests/test_kernels.py holds the Pallas
kernel to (its online softmax sums in another order than one softmax);
bfloat16 within 2e-2, one bfloat16 rounding of outputs of order 1. The
Pallas kernel takes one sequence: the port's batch dimension is compared
sequence by sequence (the reference batches it with vmap)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

F32_TOL = 2e-4
BF16_TOL = 2e-2


def _inputs(rng, shapes, jdtype, tdtype):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdtype) for a in arrs],
            [torch.from_numpy(a).to(tdtype) for a in arrs])


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               torch_out.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("h,hkv,sq,skv,d,causal,off", [
    (4, 4, 128, 128, 64, True, 0),
    (8, 2, 128, 256, 64, True, 128),   # GQA + decode-style offset
    (4, 1, 64, 128, 128, False, 0),    # MQA, bidirectional
    (2, 2, 256, 256, 32, True, 0),
])
def test_plain_matches_pallas_and_ref(h, hkv, sq, skv, d, causal, off):
    rng = np.random.default_rng(h * 100 + skv)
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(h, sq, d), (hkv, skv, d), (hkv, skv, d)], jnp.float32,
        torch.float32)
    out = fa.flash_attention(tq[None], tk[None], tv[None], causal=causal,
                             kv_offset=off)[0]
    _close(jax_flash(q, k, v, causal=causal, kv_offset=off, block_q=64,
                     block_k=64), out, F32_TOL)
    _close(ref.flash_attention_ref(q, k, v, causal=causal, kv_offset=off),
           out, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes(dtype):
    """float32 and bfloat16 inputs; the output keeps the input's dtype."""
    rng = np.random.default_rng(1)
    tdtype = getattr(torch, dtype)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(2, 128, 64)] * 3,
                                      getattr(jnp, dtype), tdtype)
    out = fa.flash_attention(tq[None], tk[None], tv[None], causal=True)[0]
    assert out.dtype == tdtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(jax_flash(q, k, v, causal=True), out, tol)
    _close(ref.flash_attention_ref(q, k, v, causal=True), out, tol)


def test_plain_batched_matches_vmapped_pallas():
    rng = np.random.default_rng(2)
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(3, 4, 128, 64), (3, 2, 128, 64), (3, 2, 128, 64)],
        jnp.float32, torch.float32)
    out_j = jax.vmap(lambda q, k, v: jax_flash(q, k, v, causal=True))(q, k, v)
    _close(out_j, fa.flash_attention(tq, tk, tv, causal=True), F32_TOL)


@pytest.mark.parametrize("group", [1, 4])
def test_plain_decode_row_with_offset(group):
    """Sq = 1 at kv_offset = 100 over a 192-row cache: the query sees keys
    0..100, the unwritten rows past it are masked (the decode step's
    call)."""
    rng = np.random.default_rng(3 + group)
    hkv, skv, d, off = 2, 192, 64, 100
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(hkv * group, 1, d), (hkv, skv, d), (hkv, skv, d)],
        jnp.float32, torch.float32)
    out = fa.flash_attention(tq[None], tk[None], tv[None], causal=True,
                             kv_offset=off)[0]
    _close(ref.flash_attention_ref(q, k, v, causal=True, kv_offset=off), out,
           F32_TOL)
    # only the visible prefix matters
    trunc = fa.flash_attention(tq[None], tk[None, :, :off + 1],
                               tv[None, :, :off + 1], causal=False)[0]
    torch.testing.assert_close(out, trunc, rtol=1e-6, atol=1e-6)


def test_plain_takes_transposed_views():
    """The model passes [B, S, H, D] tensors as transposed views."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 40, 6, 32)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 40, 3, 32)).astype(
        np.float32))
    a = fa.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                           kv.transpose(1, 2), causal=True)
    b = fa.flash_attention(x.transpose(1, 2).contiguous(),
                           kv.transpose(1, 2).contiguous(),
                           kv.transpose(1, 2).contiguous(), causal=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_validates_and_counts_only_launches():
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="kv_offset"):
        fa.flash_attention(q, q, q, kv_offset=-1)
    before = fa.launches
    fa.flash_attention(q, q, q)                       # CPU: plain version
    assert fa.launches == before
