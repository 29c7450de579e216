"""``--arch <id>`` registry of the architectures the port runs.

The reference registers ten; the port has the dense and MoE LMs and the
recsys models. ``get_arch`` of one it does not have yet (the GNN, which
the reference only trains) raises and says so.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "dlrm-rm2": "dlrm_rm2",
    "din": "din",
    "two-tower-retrieval": "two_tower_retrieval",
    "bert4rec": "bert4rec",
}
# Registered by the reference, not ported yet.
NOT_PORTED = ("schnet",)

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (its model "
            f"family has no PyTorch module); ported: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def all_cells():
    """Every (arch_id, shape) pair of the ported architectures."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for shape in arch.shapes:
            yield aid, shape
