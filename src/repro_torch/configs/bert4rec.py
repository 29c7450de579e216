"""bert4rec [arXiv:1904.06690]: embed_dim=64 n_blocks=2 n_heads=2
seq_len=200 interaction=bidir-seq. Item catalog set to 1M so the
retrieval_cand cell is meaningful."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import Bert4RecConfig


def _full():
    return Bert4RecConfig(n_items=1_000_000, embed_dim=64, n_blocks=2,
                          n_heads=2, seq_len=200,
                          compute_dtype=torch.bfloat16)


def _smoke():
    return Bert4RecConfig(n_items=300, embed_dim=16, n_blocks=2, n_heads=2,
                          seq_len=20)


ARCH = ArchSpec(arch_id="bert4rec", family="recsys",
                source="arXiv:1904.06690",
                make_config=_full, make_smoke=_smoke, shapes=RECSYS_SHAPES)
