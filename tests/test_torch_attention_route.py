"""K6's two CUDA routes, on the CPU: which route a call takes
(``flash_attention.route``) and the per-element bound each route is held
to on the card (``flash_attention.tolerance``).

The "mma" route rounds P to bfloat16 before the P V product, as the TPU
kernel does (``repro/kernels/flash_attention.py``, ``p.astype(v.dtype)``).
So the JAX package's own Pallas kernel, run in interpret mode in bfloat16,
computes with the rounding of that route, and its output must lie within
the "mma" bound of the port's plain version (which keeps P in float32).
Inputs are made with numpy from a seed; shapes hold at least 512 keys,
where the averages are long and the outputs small."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q_shape,k_shape,dtype,way", [
    ((4, 32, 4096, 64), (4, 8, 4128, 64), torch.bfloat16, "mma"),  # prefill
    ((4, 32, 1, 64), (4, 8, 4128, 64), torch.bfloat16, "simt"),    # decode
    ((4, 32, 4128, 64), (4, 8, 4128, 64), torch.bfloat16, "mma"),  # forward
    ((512, 2, 200, 32), (512, 2, 200, 32), torch.bfloat16, "mma"),  # bert4rec
    ((4, 32, 4096, 64), (4, 8, 4128, 64), torch.float32, "simt"),  # float32
    ((1, 4, 70, 24), (1, 2, 130, 24), torch.bfloat16, "simt"),     # D = 24
    ((1, 4, 16, 64), (1, 1, 300, 64), torch.bfloat16, "mma"),      # 64 rows
    ((1, 4, 15, 64), (1, 1, 300, 64), torch.bfloat16, "simt"),     # 60 rows
    ((1, 2, 100, 48), (1, 2, 100, 48), torch.bfloat16, "mma"),     # D = 48
])
def test_route_at_main_path_shapes(q_shape, k_shape, dtype, way):
    """Prefill, the cache-free forward and BERT4Rec's encoder take "mma";
    a decode step (4 rows per kv head), float32 and D = 24 take "simt".
    The rule reads shapes and dtype only (meta tensors, no data)."""
    assert fa.route(_meta(*q_shape, dtype=dtype),
                    _meta(*k_shape, dtype=dtype)) == way


def _bf16_inputs(seed, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((h, sq, d), (hkv, skv, d), (hkv, skv, d))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).bfloat16()[None] for a in arrs])


@pytest.mark.parametrize("h,hkv,sq,skv,d,causal,off", [
    (4, 4, 512, 512, 64, True, 0),
    (8, 2, 128, 640, 64, True, 512),        # GQA 4 at a decode-like offset
    (2, 1, 256, 1024, 32, False, 0),        # MQA, bidirectional
])
def test_mma_bound_holds_for_pallas_bf16(h, hkv, sq, skv, d, causal, off):
    """The Pallas kernel in bfloat16 (P rounded as on the "mma" route)
    lies within the "mma" bound of the plain version; the "simt" bound,
    which has no term for that rounding, does not hold for it; a zeroed
    output fails the "mma" bound."""
    (q, k, v), (tq, tk, tv) = _bf16_inputs(h * 1000 + skv, h, hkv, sq, skv, d)
    kw = dict(causal=causal, kv_offset=off)
    pallas = torch.from_numpy(np.asarray(jax_flash(
        q, k, v, causal=causal, kv_offset=off, block_q=64, block_k=64),
        np.float32))[None]
    ref = fa.flash_attention_plain(tq, tk, tv, **kw)
    diff = (pallas - ref.float()).abs()
    bound = fa.tolerance(tq, tk, tv, ref, "mma", **kw)
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert not bool((diff <= fa.tolerance(tq, tk, tv, ref, "simt",
                                          **kw)).all())
    assert not bool((ref.float().abs() <= bound).all())      # zeros fail


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_float32_and_simt_unchanged(dtype):
    """float32: 2e-4 + 2e-4 |plain| on either route; bfloat16 "simt":
    1e-2 |plain| + 1e-4 (p @ |v|), the bounds of the single-route kernel;
    "mma" adds 2^-8 (p @ |v|) in bfloat16."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((2, 8, 40, 32), (2, 2, 90, 32),
                                    (2, 2, 90, 32)))
    kw = dict(causal=True, kv_offset=50)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    simt = fa.tolerance(q, k, v, ref, "simt", **kw)
    mma = fa.tolerance(q, k, v, ref, "mma", **kw)
    if dtype == torch.float32:
        before = 2e-4 + 2e-4 * ref.abs()
        assert torch.equal(simt, before) and torch.equal(mma, before)
        return
    mag = fa.flash_attention_plain(q, k, v.abs(), **kw).float()
    assert torch.equal(simt, 1e-2 * ref.float().abs() + 1e-4 * mag)
    assert torch.equal(mma, 1e-2 * ref.float().abs()
                       + (2.0 ** -8 + 1e-4) * mag)
    with pytest.raises(ValueError, match="route"):
        fa.tolerance(q, k, v, ref, "wgmma", **kw)


def test_cpu_call_moves_no_route_counter():
    """A CPU tensor runs the plain version whatever its route."""
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    assert fa.route(q, q) == "mma"
    before, total = dict(fa.launches_by_route), fa.launches
    fa.flash_attention(q, q, q)
    assert fa.launches_by_route == before and fa.launches == total
