"""``--arch <id>`` registry of the ten architectures: the dense and MoE
LMs, SchNet (the GNN) and the recsys models, as the reference's."""
from __future__ import annotations

import importlib

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "schnet": "schnet",
    "dlrm-rm2": "dlrm_rm2",
    "din": "din",
    "two-tower-retrieval": "two_tower_retrieval",
    "bert4rec": "bert4rec",
}
ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def all_cells():
    """Every (arch_id, shape) pair: the 40-cell grid."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for shape in arch.shapes:
            yield aid, shape
