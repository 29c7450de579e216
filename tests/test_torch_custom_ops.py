"""K5 (``embedding_bag``) and K6 (``flash_attention``) as torch custom ops.

``torch.library.opcheck`` on CPU inputs (the op's plain version, its fake
implementation, its schema and its dispatch), the FLOP formulas that
``FlopCounterMode`` reads against counts made by brute force, the fake
implementations' checks, and the DTensor sharding rules on a fake world
of 8 ranks (shapes only) and through the plain version on one rank.
"""
import itertools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa


def _qkv(b, h, hkv, sq, skv, d, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype) for shape in
                 ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


@pytest.mark.parametrize("causal,kv_offset",
                         [(True, 0), (True, 5), (True, 40), (False, 0),
                          (False, 7)])
def test_flash_attention_opcheck(causal, kv_offset):
    q, k, v = _qkv(2, 4, 2, 6, 11, 16)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, k, v, causal, None, kv_offset, False))
    # transposed views of [B, S, H, D]: the output keeps q's layout
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (qt, kt, vt, causal, 0.3, kv_offset, True))
    out = fa.flash_attention(qt, kt, vt, causal=causal, kv_offset=kv_offset)
    assert out.stride() == qt.stride()
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, v, causal=causal, kv_offset=kv_offset))


def _pairs_brute(sq, skv, causal, kv_offset):
    return sum(1 for i, j in itertools.product(range(sq), range(skv))
               if not causal or j <= kv_offset + i)


@pytest.mark.parametrize("sq,skv", [(1, 1), (1, 9), (6, 11), (11, 6),
                                    (16, 16), (3, 64)])
def test_flash_attention_flops_formula(sq, skv):
    """4 D per visible (query, key) pair per head, causal at an offset."""
    b, h, hkv, d = 2, 4, 2, 16
    for causal, off in itertools.product((True, False), (0, 1, 5, 70)):
        want = 4 * d * b * h * _pairs_brute(sq, skv, causal, off)
        assert fa.flops((b, h, sq, d), (b, hkv, skv, d), causal, off) == want
        q, k, v = _qkv(b, h, hkv, sq, skv, d)
        with FlopCounterMode(display=False) as m:
            fa.flash_attention(q, k, v, causal=causal, kv_offset=off)
        assert m.get_total_flops() == want, (causal, off)


def test_embedding_bag_opcheck_and_flops():
    g = torch.Generator().manual_seed(0)
    table = torch.randn(10, 8, generator=g)
    idx = torch.randint(-2, 12, (3, 4), generator=g, dtype=torch.int32)
    w = torch.randn(3, 4, generator=g)
    torch.library.opcheck(torch.ops.repro_torch.embedding_bag.default,
                          (table, idx, w))
    stacked = torch.randn(2, 10, 8, generator=g)
    idx3 = torch.randint(0, 10, (3, 2, 5), generator=g, dtype=torch.int32)
    w3 = torch.randn(3, 2, 5, generator=g)
    torch.library.opcheck(torch.ops.repro_torch.embedding_bag.default,
                          (stacked, idx3, w3))
    assert torch.equal(eb.embedding_bag(table, idx, w),
                       eb.embedding_bag_plain(table, idx, w))
    # 2 D per (bag, index) pair, padding and out-of-range slots included
    for args, pairs in (((table, idx, w), 12), ((stacked, idx3, w3), 30)):
        with FlopCounterMode(display=False) as m:
            eb.embedding_bag(*args)
        assert m.get_total_flops() == 2 * 8 * pairs
        assert eb.flops(args[0].shape, args[1].shape) == 2 * 8 * pairs


def test_fake_implementations_check_as_the_real_calls():
    """The fake implementations raise where a real call would, without
    reading data: shapes on any device; on CUDA fake tensors also the
    dtypes and head dims the kernels take."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    def cuda(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="cuda")

    with FakeTensorMode():
        q, k = cuda(2, 4, 3, 64), cuda(2, 2, 9, 64)
        out = fa.flash_attention(q, k, k, kv_offset=6)
        assert out.shape == q.shape and out.device.type == "cuda"
        assert out.stride() == q.stride()
        big, big_kv = cuda(2, 4, 3, 256), cuda(2, 2, 3, 256)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(big, big_kv, big_kv)
        with pytest.raises(ValueError, match="share one of"):
            fa.flash_attention(q, cuda(2, 2, 9, 64, dtype=torch.float32), k)
        with pytest.raises(ValueError, match="kv heads"):
            fa.flash_attention(q, cuda(2, 3, 9, 64), cuda(2, 3, 9, 64))
        t = cuda(5, 8, dtype=torch.float32)
        i = cuda(3, 4, dtype=torch.int32)
        w = cuda(3, 4, dtype=torch.float32)
        assert eb.embedding_bag(t, i, w).shape == (3, 8)
        with pytest.raises(ValueError, match="int32"):
            eb.embedding_bag(t, cuda(3, 4, dtype=torch.int64), w)
        with pytest.raises(ValueError, match="weights"):
            eb.embedding_bag(t, i, cuda(3, 2, dtype=torch.float32))


def test_cpu_calls_that_autograd_records_stay_differentiable():
    q, k, v = _qkv(1, 2, 1, 3, 5, 8)
    q.requires_grad_(True)
    fa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    table = torch.randn(6, 4, requires_grad=True)
    idx = torch.tensor([[0, 5]], dtype=torch.int32)
    eb.embedding_bag(table, idx, torch.ones(1, 2)).sum().backward()
    assert table.grad[[0, 5]].eq(1).all() and table.grad[1:5].eq(0).all()


def test_sharding_rules_on_a_fake_world():
    """K6's rule keeps a batch or head split (the heads only where the
    mesh divides the kv heads); K5's keeps a split of the bags over a
    whole table. Shapes only: a fake world of 8 ranks, fake shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_mesh

    def put(shape, place, mesh, dtype=torch.float32):
        local = list(shape)
        for m, p in enumerate(place):
            if p.is_shard():
                local[p.dim] //= mesh.shape[m]
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                                  place, run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    with fake_world(8):
        mesh = make_mesh(4, 2, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            for hkv, want in ((4, (Shard(0), Shard(1))),
                              (1, (Shard(0), Replicate()))):
                pl = (Shard(0), Shard(1)) if hkv > 1 else (Shard(0),
                                                           Replicate())
                q = put((8, 8, 5, 16), (Shard(0), Shard(1)), mesh)
                k = put((8, hkv, 7, 16), pl, mesh)
                out = fa.flash_attention(q, k, k, kv_offset=2)
                assert tuple(out.placements) == want, hkv
                assert tuple(out.shape) == (8, 8, 5, 16)
            table = put((40, 8), (Replicate(), Replicate()), mesh)
            idx = put((8, 3), (Shard(0), Replicate()), mesh, torch.int32)
            w = put((8, 3), (Shard(0), Replicate()), mesh)
            out = eb.embedding_bag(table, idx, w)
            assert tuple(out.placements) == (Shard(0), Replicate())
            assert tuple(out.to_local().shape) == (2, 8)


def test_sharding_rules_one_rank_equal_plain(tmp_path):
    """The rules' strategies on a gloo world of one rank (a 1 x 1 mesh):
    DTensor calls equal the plain calls bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        q, k, v = _qkv(2, 4, 2, 3, 6, 16)
        dq, dk, dv = (distribute_tensor(t, mesh, (Shard(0), Shard(1)))
                      for t in (q, k, v))
        got = fa.flash_attention(dq, dk, dv, kv_offset=3)
        assert torch.equal(got.full_tensor(),
                           fa.flash_attention(q, k, v, kv_offset=3))
        rng = np.random.default_rng(0)
        table = torch.from_numpy(rng.standard_normal((30, 8)).astype(
            np.float32))
        idx = torch.from_numpy(rng.integers(0, 30, (4, 5)).astype(np.int32))
        w = torch.ones(4, 5)
        got = eb.embedding_bag(distribute_tensor(table, mesh),
                               *(distribute_tensor(t, mesh, (Shard(0),
                                                             Shard(0)))
                                 for t in (idx, w)))
        assert torch.equal(got.full_tensor(), eb.embedding_bag(table, idx, w))
    finally:
        dist.destroy_process_group()
