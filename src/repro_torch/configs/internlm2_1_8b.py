"""internlm2-1.8b [arXiv:2403.17297; hf]: 24L d=2048 16H (GQA kv=8)
d_ff=8192 vocab=92544."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def _full():
    return TransformerConfig(
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
        vocab=92544, tie_embeddings=True, compute_dtype=torch.bfloat16,
        attn_chunk=1024)


def _smoke():
    return TransformerConfig(
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab=384, compute_dtype=torch.float32, remat=False)


ARCH = ArchSpec(arch_id="internlm2-1.8b", family="lm",
                source="arXiv:2403.17297",
                make_config=_full, make_smoke=_smoke, shapes=LM_SHAPES)
