"""The embedding-bag kernel's plain PyTorch version against the Pallas
kernel (interpret mode) and the reference's oracle, and the port's
``sparse_ops`` against the reference's.

Tolerance: rtol/atol 1e-5, the bound tests/test_kernels.py holds the
Pallas kernel to (the oracle sums a bag in another order than the
kernel's j order); the weight-0 padding case is exact. The CUDA kernel is
held bit-equal to the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse_ops as jops
from repro.kernels import ref
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro_torch import sparse_ops as tops
from repro_torch.kernels import embedding_bag as eb

TOL = 1e-5


def _close(jax_out, torch_out):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("v,d,b,l", [
    (64, 32, 16, 4), (256, 128, 32, 8), (1000, 64, 8, 12)])
def test_plain_matches_pallas_and_ref(v, d, b, l):
    rng = np.random.default_rng(v + b)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    out = eb.embedding_bag(*map(torch.from_numpy, (table, idx, w)))
    _close(jax_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w),
                   block_b=min(8, b)), out)
    _close(ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                 jnp.asarray(w)), out)


def test_plain_padding_weights():
    table = np.eye(8, 4, dtype=np.float32)
    idx = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    w = np.array([[1.0, 1.0, 0.0], [2.0, 0.0, 0.0]], np.float32)
    out = eb.embedding_bag(*map(torch.from_numpy, (table, idx, w)))
    expect = np.zeros((2, 4), np.float32)
    expect[0, 1] = expect[0, 2] = 1.0
    expect[1, 3] = 2.0
    np.testing.assert_array_equal(out.numpy(), expect)
    np.testing.assert_array_equal(
        np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(w), block_b=2)), expect)


def test_plain_adds_in_j_order_and_skips_out_of_range():
    """The bag sum is ((0 + r0 w0) + r1 w1) + ... in the table's dtype; an
    index outside [0, V) adds nothing."""
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.from_numpy(rng.standard_normal((50, 16)).astype(
            np.float32)).to(dtype)
        idx = torch.from_numpy(rng.integers(0, 50, (6, 7)).astype(np.int32))
        w = torch.from_numpy(rng.random((6, 7)).astype(np.float32)).to(dtype)
        expect = torch.zeros(6, 16, dtype=dtype)
        for j in range(7):
            expect = expect + table[idx[:, j].long()] * w[:, j, None]
        torch.testing.assert_close(eb.embedding_bag(table, idx, w), expect,
                                   rtol=0, atol=0)
        bad = idx.clone()
        bad[:, 3] = torch.tensor([-1, 50, 10 ** 6, -7, 50, 99],
                                 dtype=torch.int32)
        keep = torch.ones_like(w)
        keep[:, 3] = 0
        torch.testing.assert_close(eb.embedding_bag(table, bad, w),
                                   eb.embedding_bag(table, idx, w * keep),
                                   rtol=0, atol=0)


def test_plain_stacked_fields_equal_one_call_per_field():
    rng = np.random.default_rng(6)
    tables = torch.from_numpy(rng.standard_normal((5, 40, 8)).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (9, 5, 3)).astype(np.int32))
    w = torch.from_numpy(rng.random((9, 5, 3)).astype(np.float32))
    out = eb.embedding_bag(tables, idx, w)
    assert out.shape == (9, 5, 8)
    for f in range(5):
        torch.testing.assert_close(
            out[:, f], eb.embedding_bag(tables[f], idx[:, f].contiguous(),
                                        w[:, f].contiguous()),
            rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("with_weights", [True, False])
def test_sparse_ops_embedding_bag_matches_reference(mode, with_weights):
    rng = np.random.default_rng(7)
    table = rng.standard_normal((300, 24)).astype(np.float32)
    idx = rng.integers(0, 300, (10, 6)).astype(np.int32)
    w = None
    if with_weights:
        w = (rng.random((10, 6)) * (rng.random((10, 6)) < 0.7)).astype(
            np.float32)
        w[0] = 0.0                                  # an all-padding bag
    out = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             None if w is None else torch.from_numpy(w),
                             mode=mode)
    _close(jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              None if w is None else jnp.asarray(w),
                              mode=mode), out)


def test_sparse_ops_segment_functions_match_reference():
    rng = np.random.default_rng(8)
    n_seg, n = 7, 40
    seg = rng.integers(0, n_seg - 1, n).astype(np.int32)   # segment 6 empty
    scores = rng.standard_normal(n).astype(np.float32) * 3
    vals2 = rng.standard_normal((n, 5)).astype(np.float32)
    t = torch.from_numpy
    _close(jops.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), n_seg),
           tops.segment_softmax(t(scores), t(seg), n_seg))
    for vals in (scores, vals2):
        _close(jops.scatter_mean(jnp.asarray(vals), jnp.asarray(seg), n_seg),
               tops.scatter_mean(t(vals), t(seg), n_seg))
    _close(jops.degree(jnp.asarray(seg), n_seg), tops.degree(t(seg), n_seg))


def test_sparse_ops_segment_softmax_2d_scores():
    """Per-head edge scores [E, H]: each column normalised per segment."""
    rng = np.random.default_rng(9)
    seg = rng.integers(0, 4, 30).astype(np.int32)
    scores = rng.standard_normal((30, 3)).astype(np.float32)
    _close(jops.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 4),
           tops.segment_softmax(torch.from_numpy(scores),
                                torch.from_numpy(seg), 4))


def test_kernel_wrapper_validates():
    table = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="expected"):
        eb.embedding_bag(table, torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3))
    with pytest.raises(ValueError, match="weights"):
        eb.embedding_bag(table, torch.zeros(3, 2, dtype=torch.int32),
                         torch.zeros(3, 3))
    with pytest.raises(ValueError, match="mode"):
        tops.embedding_bag(table, torch.zeros(3, 2, dtype=torch.int32),
                           mode="max")
