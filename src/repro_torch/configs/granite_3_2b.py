"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L d=2048 32H
(GQA kv=8) d_ff=8192 vocab=49155."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def _full():
    return TransformerConfig(
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
        vocab=49155, tie_embeddings=True, compute_dtype=torch.bfloat16,
        attn_chunk=1024)


def _smoke():
    return TransformerConfig(
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab=384, compute_dtype=torch.float32, remat=False)


ARCH = ArchSpec(arch_id="granite-3-2b", family="lm",
                source="hf:ibm-granite/granite-3.0-2b-base",
                make_config=_full, make_smoke=_smoke, shapes=LM_SHAPES)
