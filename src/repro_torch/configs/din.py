"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80 interaction=target-attn."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DINConfig


def _full():
    return DINConfig(embed_dim=18, seq_len=100, n_items=1_000_000,
                     attn_mlp=(80, 40), mlp=(200, 80))


def _smoke():
    return DINConfig(embed_dim=8, seq_len=20, n_items=500,
                     attn_mlp=(16, 8), mlp=(16, 8))


ARCH = ArchSpec(arch_id="din", family="recsys", source="arXiv:1706.06978",
                make_config=_full, make_smoke=_smoke, shapes=RECSYS_SHAPES)
