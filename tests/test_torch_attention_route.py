"""K6's three CUDA routes, on the CPU: which route a call takes
(``flash_attention.route``: "split", "mma" or "f32"; no route keeps P
in float32 in bfloat16), how the "split" route divides the keys (``split_plan``) and
joins its partials, and the per-element bound each route is held to on
the card (``flash_attention.tolerance``).

The "mma" and "split" routes round P to bfloat16 before the P V product,
as the TPU kernel does (``repro/kernels/flash_attention.py``,
``p.astype(v.dtype)``). So the JAX package's own Pallas kernel, run in
interpret mode in bfloat16, computes with the rounding of those routes,
and its output must lie within their bound of the port's plain version
(which keeps P in float32). Inputs are made with numpy from a seed;
shapes hold at least 512 keys, where the averages are long and the
outputs small."""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q_shape,k_shape,dtype,way", [
    ((4, 32, 4096, 64), (4, 8, 4128, 64), torch.bfloat16, "mma"),  # prefill
    ((4, 32, 1, 64), (4, 8, 4128, 64), torch.bfloat16, "split"),   # decode
    ((4, 32, 4128, 64), (4, 8, 4128, 64), torch.bfloat16, "mma"),  # forward
    ((512, 2, 200, 32), (512, 2, 200, 32), torch.bfloat16, "mma"),  # bert4rec
    ((4, 32, 4096, 64), (4, 8, 4128, 64), torch.float32, "f32"),   # float32
    ((1, 4, 70, 24), (1, 2, 130, 24), torch.bfloat16, "mma"),      # D = 24
    ((1, 4, 16, 64), (1, 1, 300, 64), torch.bfloat16, "mma"),      # 64 rows
    ((1, 4, 15, 64), (1, 1, 300, 64), torch.bfloat16, "mma"),      # 60 rows
    ((1, 2, 100, 48), (1, 2, 100, 48), torch.bfloat16, "mma"),     # D = 48
    ((1, 8, 4, 64), (1, 2, 300, 64), torch.bfloat16, "split"),     # 16 rows
    ((1, 1, 17, 64), (1, 1, 300, 64), torch.bfloat16, "mma"),      # 17 rows
    ((1, 4, 1, 24), (1, 2, 130, 24), torch.bfloat16, "split"),     # D = 24
    ((1, 4, 1, 20), (1, 2, 130, 20), torch.bfloat16, None),        # D % 8
    ((4, 32, 1, 64), (4, 8, 4128, 64), torch.float32, "f32"),      # f32 decode
])
def test_route_at_main_path_shapes(q_shape, k_shape, dtype, way):
    """Prefill, the cache-free forward and BERT4Rec's encoder take "mma",
    as does every bfloat16 call above 16 rows per kv head (17-63 rows, D
    = 24); a bfloat16 decode step (4 rows per kv head) and any bfloat16
    call of at most 16 rows take "split"; float32 takes "f32". A head dim
    no kernel takes (bfloat16 D % 8 != 0) raises. The rule reads shapes
    and dtype only (meta tensors, no data)."""
    q, k = _meta(*q_shape, dtype=dtype), _meta(*k_shape, dtype=dtype)
    if way is None:
        with pytest.raises(ValueError, match="head dim"):
            fa.route(q, k)
        return
    assert fa.route(q, k) == way


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 8), (torch.bfloat16, 24), (torch.bfloat16, 64),
    (torch.bfloat16, 128), (torch.float32, 4), (torch.float32, 36),
    (torch.float32, 64), (torch.float32, 128)])
def test_route_never_returns_simt(dtype, d):
    """Over a grid of groups, query lengths and kv lengths: float32 always
    takes "f32"; bfloat16 takes "split" at <= 16 rows per kv head and
    "mma" above, so every bfloat16 call rounds P as the TPU kernel does.
    The simt kernel is reached by no shape."""
    assert "simt" not in fa.ROUTES and set(fa.launches_by_route) == set(
        fa.ROUTES)
    for h, hkv in ((1, 1), (4, 1), (8, 2), (32, 8), (16, 16)):
        for sq in (1, 2, 3, 4, 5, 15, 16, 17, 33, 63, 64, 100, 4096):
            for skv in (1, 130, 4128):
                way = fa.route(_meta(1, h, sq, d, dtype=dtype),
                               _meta(1, hkv, skv, d, dtype=dtype))
                rows = h // hkv * sq
                assert way == ("f32" if dtype == torch.float32 else
                               "split" if rows <= 16 else "mma"), (h, sq)


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
    (32, 8, 4, 1024, 64, True, 1020),       # decode rows (split), GQA 4
])
def test_mma_bound_holds_for_pallas_bf16(h, hkv, sq, skv, d, causal, off):
    """The Pallas kernel in bfloat16 (P rounded as on the "mma" and
    "split" routes) lies within their bound of the plain version; the
    "unrounded" bound (a kernel keeping P in float32), which has no term
    for that rounding, does not hold for it; a zeroed output fails the
    bound."""
    (q, k, v), (tq, tk, tv) = _bf16_inputs(h * 1000 + skv, h, hkv, sq, skv, d)
    kw = dict(causal=causal, kv_offset=off)
    pallas = torch.from_numpy(np.asarray(jax_flash(
        q, k, v, causal=causal, kv_offset=off, block_q=64, block_k=64),
        np.float32))[None]
    ref = fa.flash_attention_plain(tq, tk, tv, **kw)
    diff = (pallas - ref.float()).abs()
    bound = fa.tolerance(tq, tk, tv, ref, "mma", **kw)
    assert torch.equal(bound, fa.tolerance(tq, tk, tv, ref, "split", **kw))
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert not bool((diff <= fa.tolerance(tq, tk, tv, ref, "unrounded",
                                          **kw)).all())
    assert not bool((ref.float().abs() <= bound).all())      # zeros fail


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_float32_and_simt_unchanged(dtype):
    """float32: 2e-4 + 2e-4 |plain| on every route; bfloat16
    "unrounded" (a kernel keeping P in float32): 1e-2 |plain| + 1e-4
    (p @ |v|); "mma" and "split" add 2^-8 (p @ |v|) in bfloat16. A name
    that is neither a route nor "unrounded" is no bound."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((2, 8, 40, 32), (2, 2, 90, 32),
                                    (2, 2, 90, 32)))
    kw = dict(causal=True, kv_offset=50)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    simt = fa.tolerance(q, k, v, ref, "unrounded", **kw)
    mma = fa.tolerance(q, k, v, ref, "mma", **kw)
    assert torch.equal(mma, fa.tolerance(q, k, v, ref, "split", **kw))
    if dtype == torch.float32:
        before = 2e-4 + 2e-4 * ref.abs()
        assert torch.equal(simt, before) and torch.equal(mma, before)
        return
    mag = fa.flash_attention_plain(q, k, v.abs(), **kw).float()
    assert torch.equal(simt, 1e-2 * ref.float().abs() + 1e-4 * mag)
    assert torch.equal(mma, 1e-2 * ref.float().abs()
                       + (2.0 ** -8 + 1e-4) * mag)
    for name in ("wgmma", "simt"):
        with pytest.raises(ValueError, match="route"):
            fa.tolerance(q, k, v, ref, name, **kw)


def _code(source: str) -> str:
    """A CUDA source with its // and /* */ comments taken out."""
    text = (build.CSRC / source).read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("source", build.SOURCES)
def test_kernels_target_sm90a_and_mma_issues_wgmma(source):
    """Every kernel builds for sm_90a alone (wgmma exists only there;
    plain sm_90 refuses it), and the "mma" route's source issues both of
    its products as wgmma.mma_async, with no mma.sync left."""
    flags = build.flags(source)
    targets = [flags[i + 1] for i, f in enumerate(flags) if f == "-gencode"]
    assert targets == ["arch=compute_90a,code=sm_90a"]
    assert not any(f.startswith(("-arch", "--gpu-architecture"))
                   for f in flags)
    if source == fa.SOURCES["mma"]:
        code = _code(source)
        assert code.count("wgmma.mma_async") >= 2     # S and P V
        assert "mma.sync" not in code


def test_cpu_call_moves_no_route_counter():
    """A CPU tensor runs the plain version whatever its route."""
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    assert fa.route(q, q) == "mma"
    before, total = dict(fa.launches_by_route), fa.launches
    fa.flash_attention(q, q, q)
    assert fa.launches_by_route == before and fa.launches == total


@pytest.mark.parametrize("batch,hkv,n_keys,n_sm,plan", [
    (4, 8, 4098, 132, (9, 512)),     # granite decode: 288 blocks of 8 tiles
    (1, 1, 300, 132, (5, 64)),       # fewer tiles than wanted blocks
    (128, 8, 4098, 132, (1, 4160)),  # enough kv heads: one split
    (2, 2, 1000, 132, (16, 64)),
    (4, 8, 0, 132, (1, 64)),         # no key at all
])
def test_split_plan(batch, hkv, n_keys, n_sm, plan):
    """At least 2 blocks per SM where the tiles allow it, every split but
    the last a whole number of 64-key tiles, and no split without keys."""
    n_split, split_keys = fa.split_plan(batch, hkv, n_keys, n_sm)
    assert (n_split, split_keys) == plan
    tiles = -(-n_keys // 64)
    assert split_keys % 64 == 0
    assert batch * hkv * n_split >= min(2 * n_sm, batch * hkv * tiles)
    assert (n_split - 1) * split_keys < max(n_keys, 1) <= n_split * split_keys


def _split_partials(q, k, v, lo, hi, causal, kv_offset):
    """The float32 partial (m, l, acc) of the keys lo .. hi - 1, as one
    block of the split kernel leaves it: m = -inf, l = 0, acc = 0 for a row
    that sees none of them."""
    group = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()
                     .repeat_interleave(group, 1)) / math.sqrt(q.shape[-1])
    key = torch.arange(k.shape[2])
    seen = (key >= lo) & (key < hi)
    if causal:
        pos = kv_offset + torch.arange(q.shape[2])[:, None]
        seen = seen & (key[None] <= pos)
    s = s.masked_fill(~seen, -math.inf)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(m == -math.inf, 0.0, m))
    acc = torch.einsum("bhqk,bhkd->bhqd", e,
                       v.float().repeat_interleave(group, 1))
    return m, e.sum(-1, keepdim=True), acc


def _combine(parts):
    """The combine kernel's join of the splits' partials."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    mu = torch.where(m == -math.inf, 0.0, m)
    l = sum(p[1] * torch.exp(p[0] - mu) for p in parts)
    acc = sum(p[2] * torch.exp(p[0] - mu) for p in parts)
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("sq,skv,causal,off,bounds", [
    (1, 300, True, 299, [0, 64, 192, 256, 300]),      # uneven, mid-tile end
    (4, 700, True, 500, [0, 128, 384, 504, 640]),     # an empty split
    (3, 330, False, 0, [0, 330]),                      # one split
    (2, 1000, True, 998, "plan"),                      # split_plan's ranges
])
def test_split_and_combine_equal_one_pass(sq, skv, causal, off, bounds):
    """Partials over contiguous key ranges, joined with m = max m_s,
    l = sum l_s e^(m_s - m), out = sum acc_s e^(m_s - m) / max(l, 1e-30),
    give the one-pass plain version in float32 (within 1e-5: the sums run
    in another order). The split of [504, 640) sees no key of any row
    (causal rows end at 503) and adds nothing."""
    rng = np.random.default_rng(skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 8, sq, 32), (2, 2, skv, 32), (2, 2, skv, 32)))
    n_keys = min(skv, off + sq) if causal else skv
    if bounds == "plan":
        n_split, per = fa.split_plan(2, 2, n_keys, n_sm=132)
        bounds = [min(i * per, n_keys) for i in range(n_split + 1)]
        assert n_split > 1 and bounds[-1] - bounds[-2] < per   # short last
    parts = [_split_partials(q, k, v, lo, hi, causal, off)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    if off == 500:
        assert bool((parts[-1][0] == -math.inf).all())
        assert bool((parts[-1][1] == 0).all())
    ref = fa.flash_attention_plain(q, k, v, causal=causal, kv_offset=off)
    torch.testing.assert_close(_combine(parts), ref, rtol=1e-5, atol=1e-5)
