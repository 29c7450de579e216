"""``models.transformer.Rules`` on DTensors: the reference's sharding
constraints (``Rules.c``, ``Rules.w``) acting on the port's tensors.

A smoke-width LM (dense, and MoE through ``_moe_ffn_sharded``) runs its
forward with DTensor parameters laid out by ``param_shardings`` under the
tp and fsdp rules on 8 gloo ranks (a 4 x 2 mesh; subprocesses with jax
and the reference blocked), and must equal the same forward on plain
tensors within float32 rounding (rtol 1e-5: the sharded products add in
another order). On plain tensors the rules change nothing, bit for bit.
"""
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.dist import sharding as SH
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as T

from torch_ranks import BLOCK_JAX, run_ranks


def test_rules_leave_plain_tensors_bit_equal():
    """A dense LM's forward, loss and logits under the tp and fsdp rules of
    a 4 x 2 mesh equal those without rules, bit for bit, on plain
    tensors."""
    import types
    arch = get_arch("internlm2-1.8b")
    cfg = arch.smoke()
    params = TS.init_fn(arch, "train_4k", cfg, device="cpu")(0)
    tokens = torch.randint(1, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(0))
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(4, 2))
    want = T.forward(cfg, params, tokens)[0]
    want_loss = T.lm_loss(cfg, params, {"tokens": tokens, "targets": tokens})
    for variant in ("tp", "fsdp"):
        rules = SH.activation_rules(mesh, variant)
        assert torch.equal(T.forward(cfg, params, tokens, rules)[0], want)
        assert torch.equal(T.lm_loss(cfg, params, {
            "tokens": tokens, "targets": tokens}, rules), want_loss)
    w = torch.ones(3, 4)
    assert T.Rules(gather_weights=True).w(w, torch.bfloat16).dtype == \
        torch.bfloat16
    assert T.Rules(batch=("data",)).c(w, (("data",), None)) is w


_FORWARD = BLOCK_JAX + textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (activation_rules, param_shardings,
                                           placements, P)
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store, 8),
                            rank=rank, world_size=8)
    mesh = make_mesh(4, 2, device_type="cpu")
    res = {}
    for arch_id in ("internlm2-1.8b", "granite-moe-1b-a400m"):
        arch = get_arch(arch_id)
        cfg = arch.smoke()
        params = TS.init_fn(arch, "train_4k", cfg, device="cpu")(0)
        tokens = torch.randint(1, cfg.vocab, (8, 16),
                               generator=torch.Generator().manual_seed(1))
        for variant in ("tp", "fsdp"):
            rules = activation_rules(mesh, variant)
            want_h, want_aux, _ = T.forward(cfg, params, tokens, rules)
            want = T.logits_fn(cfg, params, want_h, rules)
            specs = param_shardings("lm", cfg, mesh, params, variant)
            placed = unflatten(params, [
                distribute_tensor(p, mesh, placements(s, mesh),
                                  src_data_rank=None)
                for p, s in zip(leaves(params), leaves_up_to(params, specs))])
            tok = distribute_tensor(tokens, mesh, placements(
                P(("data",), None), mesh), src_data_rank=None)
            with implicit_replication():
                h, aux, _ = T.forward(cfg, placed, tok, rules)
                got = T.logits_fn(cfg, placed, h, rules)
            res[f"{arch_id}/{variant}"] = {
                "hidden": [h.full_tensor().tolist(), want_h.tolist()],
                "logits": [got.full_tensor().tolist(), want.tolist()],
                "aux": [float(aux.full_tensor() if hasattr(aux, "full_tensor")
                              else aux), float(want_aux)],
                "placements": str(h.placements)}
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(res))
''')


def test_dtensor_forward_on_8_ranks_equals_plain(tmp_path):
    """Dense and MoE smoke LMs, tp and fsdp: the DTensor forward's hidden
    states, logits and aux loss equal the plain forward's within rtol
    1e-5 (atol 1e-5 max|ref|); under tp the hidden states keep the batch
    split."""
    out = run_ranks(_FORWARD, 8, tmp_path, timeout=300)
    for rank_out in out:
        assert len(rank_out) == 4
        for key, r in rank_out.items():
            for name in ("hidden", "logits"):
                got, want = (np.array(x) for x in r[name])
                np.testing.assert_allclose(
                    got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                    err_msg=f"{key} {name}")
            assert r["aux"][0] == pytest.approx(r["aux"][1], rel=1e-5,
                                                abs=1e-7)
            if key.endswith("/tp"):      # fsdp splits the final norm's D
                assert r["placements"].startswith("(Shard(dim=0)"), key
