"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L
d=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8, expert d_ff=512."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def _full():
    return TransformerConfig(
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=0,
        vocab=49155, moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
        tie_embeddings=True, compute_dtype=torch.bfloat16,
        attn_chunk=1024)


def _smoke():
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0, vocab=384,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
        compute_dtype=torch.float32, remat=False)


ARCH = ArchSpec(arch_id="granite-moe-1b-a400m", family="lm",
                source="hf:ibm-granite/granite-3.0-1b-a400m-base",
                make_config=_full, make_smoke=_smoke, shapes=LM_SHAPES)
