"""The port's models against the reference in bfloat16, on the CPU.

The reference model rounds the softmax weights to the compute dtype before
the P V product (``repro/models/transformer.py::_attention``,
``p.astype(v.dtype)``); the port's model asks the flash-attention plain
version for the same rounding (``round_p``). Parameters are carried over
by the bridge; inputs are made with numpy from a seed.

Tolerances:
- Attention alone: |port - ref| <= 2^-7 |ref| + 2^-12 (p @ |v|) per
  element. Both sides compute the float32 weights to within ~1e-6 of each
  other (one divides by sqrt(D), the other multiplies by its inverse, and
  the sums run in other orders); rounded to bfloat16 they are equal except
  where a weight lies that close to a rounding boundary, and such a flip
  moves p_j by one bfloat16 step (<= 2^-7 p_j). The output's own bfloat16
  rounding then differs by at most one step, <= 2^-7 |ref|; 2^-12
  (p @ |v|) leaves room for flips that carry up to 1/32 of the row's
  weighted |v|. The unrounded-P variant (the plain version's default)
  misses by up to 2^-8 (p @ |v|) and must fail this bound.
- Whole models: logits and caches within 2% of the reference's max |x|,
  the bound ``chip_smoke.py`` holds bfloat16 models to (bfloat16 keeps
  about 3 significant digits, and the two packages round their products
  and elementwise results at other places in every layer: measured 1.0%);
  argmax identical wherever the reference's top-2 margin exceeds twice the
  measured max |d| (there the bound fixes it), and top-k ids identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro.models import transformer as J
from repro.models.transformer import NO_RULES
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as T

MODEL_RTOL = 0.02


def _f32(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else \
        x.detach().float().numpy()


def _within(ref, got, rtol=MODEL_RTOL) -> float:
    """max |got - ref| <= rtol * max |ref|; returns max |d|."""
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape and np.isfinite(got).all()
    diff = float(np.abs(got - ref).max())
    assert diff <= rtol * float(np.abs(ref).max()), (diff, np.abs(ref).max())
    return diff


@pytest.mark.parametrize("b,sq,h,hkv,skv,d,off", [
    (2, 16, 8, 2, 640, 64, 600),        # GQA 4 at a decode-like offset
    (1, 64, 4, 4, 512, 32, 448),
    (2, 4, 8, 2, 1024, 64, 1020),       # a decode step's rows
])
def test_attention_rounds_p_as_reference(b, sq, h, hkv, skv, d, off):
    """The port's CPU ``attention`` against the reference's ``_attention``
    in bfloat16, over >= 512 keys: within the bound of the module
    docstring; the variant that keeps P in float32 falls outside it."""
    rng = np.random.default_rng(b * 1000 + skv)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    ref = torch.from_numpy(_f32(J._attention(
        jq, jk, jv, True, jnp.full((b,), off, jnp.int32))))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = T.attention(q, k, v, True, off)
    assert got.dtype == torch.bfloat16
    mag = fa.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.abs().transpose(1, 2),
        kv_offset=off).float().transpose(1, 2)
    bound = 2.0 ** -7 * ref.abs() + 2.0 ** -12 * mag
    diff = (got.float() - ref).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    unrounded = fa.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        kv_offset=off).transpose(1, 2)
    assert not bool(((unrounded.float() - ref).abs() <= bound).all())


def test_round_p_is_identity_in_float32():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 9, 16), (1, 2, 30, 16), (1, 2, 30, 16)))
    kw = dict(causal=True, kv_offset=21)
    assert torch.equal(fa.flash_attention_plain(q, k, v, round_p=True, **kw),
                       fa.flash_attention_plain(q, k, v, **kw))


def _bf16_lm_pair(arch_id="granite-3-2b", seed=0):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).smoke(),
                               compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch(arch_id).smoke(),
                               compute_dtype=torch.bfloat16)
    jp = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = bridge.transformer_params_from_arrays(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _argmax_where_decided(ref, got, diff):
    """Identical argmax at every position whose reference top-2 margin
    exceeds 2 diff; returns how many positions that was."""
    ref, got = _f32(ref), _f32(got)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * diff
    np.testing.assert_array_equal(ref.argmax(-1)[decided],
                                  got.argmax(-1)[decided])
    return int(decided.sum())


def test_lm_prefill_and_decode_bf16_match_reference():
    """granite-3-2b's smoke config at bfloat16 compute: prefill 10 tokens
    into a 16-position cache, then 4 decode steps, each fed the
    reference's greedy token: logits and caches against the reference's."""
    jcfg, tcfg, jp, tp = _bf16_lm_pair()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 10)).astype(
        np.int32)
    jl, jc = J.prefill(jcfg, jp, jnp.asarray(toks), max_len=16)
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(toks), max_len=16)
    assert tc["k"].dtype == torch.bfloat16 and tl.dtype == torch.float32
    decided = _argmax_where_decided(jl, tl, _within(jl, tl))
    for pos in range(10, 14):
        for key in ("k", "v"):
            _within(jc[key], tc[key])
        tok = np.asarray(jl[:, -1].argmax(-1)[:, None]).astype(np.int32)
        jl, jc = J.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                               jnp.int32(pos))
        tl, tc = T.decode_step(tcfg, tp, torch.from_numpy(tok), tc, pos)
        decided += _argmax_where_decided(jl, tl, _within(jl, tl))
    assert decided >= 5          # of the 10 positions (2 x prefill + 4)


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_bert4rec_serve_bf16_matches_reference(shape):
    """BERT4Rec's serve steps at its smoke config in bfloat16 (the full
    config's compute dtype): scores within 2% of max |ref|, top-k ids
    identical."""
    jarch, arch = jax_get_arch("bert4rec"), get_arch("bert4rec")
    jcfg = dataclasses.replace(jarch.smoke(), compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(arch.smoke(), compute_dtype=torch.bfloat16)
    jparams = JS.init_fn(jarch, shape, jcfg)(jax.random.PRNGKey(1))
    params = bridge.recsys_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jbatch = JS.smoke_batch(jarch, shape, jcfg)
    batch = TS.smoke_batch(arch, shape, cfg, device="cpu")
    jout = jax.jit(JS.make_serve_step(jarch, shape, jcfg, NO_RULES))(
        jparams, *jbatch.values())
    out = TS.make_serve_step(arch, shape, cfg)(params, *batch.values())
    jout, out = ((o,) if not isinstance(o, (tuple, list)) else o
                 for o in (jout, out))
    assert len(jout) == len(out)
    for a, b in zip(jout, out):
        if b.is_floating_point():
            _within(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
