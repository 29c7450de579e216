"""The port's collectives (``repro_torch.dist.collectives``) on
``torch.distributed`` gloo groups, against ``tests/test_dist.py``'s
collective checks.

The reference shards a stacked input over a mesh axis; in the port every
rank passes its own contribution, so each check hands rank r the slice the
reference's device r holds. A group of one rank is the identity (the
reference's 1-device mesh); on 8 ranks as a 4 x 2 (data, model) mesh, in
subprocesses with ``jax`` and ``repro`` blocked and ``slow`` as in the
reference: the ring all-reduce over data, the hierarchical all-reduce
(model groups, then data groups) over all 8, reduce-scatter then
all-gather == all-reduce, and the reduce-scatter guard, each within the
reference's 1e-5 of the numpy sum."""
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_ranks import BLOCK_JAX, run_ranks
from repro_torch.dist import (hierarchical_all_reduce, reduce_scatter,
                              ring_all_gather, ring_all_reduce,
                              ring_gather_stack)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of world size 1 in this process."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_identities_single_device(world1):
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    for fn in (ring_all_reduce, reduce_scatter, ring_all_gather):
        np.testing.assert_allclose(fn(x).numpy(), x.numpy())
    np.testing.assert_allclose(
        hierarchical_all_reduce(x, dist.group.WORLD, dist.group.WORLD)
        .numpy(), x.numpy())
    torch.testing.assert_close(ring_gather_stack(x), x[None])
    y = ring_all_reduce(x)
    assert y is not x and y.data_ptr() != x.data_ptr()   # a new tensor


_COLLECTIVE_SCRIPT = BLOCK_JAX + textwrap.dedent("""
    import json
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist import (hierarchical_all_reduce, reduce_scatter,
                                  ring_all_gather, ring_all_reduce,
                                  ring_gather_stack)

    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=8)
    # a 4 x 2 (data, model) mesh, model-minor: rank = 2 * data + model
    d, m = divmod(rank, 2)
    data_groups = [dist.new_group([mm, mm + 2, mm + 4, mm + 6])
                   for mm in range(2)]
    model_groups = [dist.new_group([2 * dd, 2 * dd + 1]) for dd in range(4)]
    data, model = data_groups[m], model_groups[d]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 5)).astype(np.float32)
    t = torch.from_numpy(x)
    out = {}
    # ring all-reduce over data: sum of the 4 contribution slices
    r = ring_all_reduce(t[4 * d:4 * d + 4], data)
    ref = x.reshape(4, 4, 5).sum(0)
    out["ring"] = float(np.abs(r.numpy() - ref).max())
    # hierarchical: intra-model then inter-data == sum of 8 slices
    h = hierarchical_all_reduce(t[2 * rank:2 * rank + 2], model, data)
    ref8 = x.reshape(8, 2, 5).sum(0)
    out["hier"] = float(np.abs(h.numpy() - ref8).max())
    # reduce-scatter + all-gather round trip == all-reduce
    rs = reduce_scatter(t[4 * d:4 * d + 4], data)
    ag = ring_all_gather(rs, data)
    out["rs_ag"] = float(np.abs(ag.numpy() - ref).max())
    # non-divisible contribution rows must be rejected, not duplicated
    try:
        reduce_scatter(t[2 * d:2 * d + 2], data)  # 2 rows, 4-way group
        out["rs_guard"] = "missing"
    except ValueError:
        out["rs_guard"] = "raised"
    # the stack is in rank order: entry j is rank j's contribution
    st = ring_gather_stack(torch.full((3,), float(rank)))
    out["stack_order"] = st[:, 0].tolist() == [float(j) for j in range(8)]
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(out))
""")


@pytest.mark.slow
def test_ring_collectives_multi_device_subprocess(tmp_path):
    outs = run_ranks(_COLLECTIVE_SCRIPT, 8, tmp_path)
    for out in outs:
        assert out["ring"] < 1e-5, out
        assert out["hier"] < 1e-5, out
        assert out["rs_ag"] < 1e-5, out
        assert out["rs_guard"] == "raised", out
        assert out["stack_order"], out
