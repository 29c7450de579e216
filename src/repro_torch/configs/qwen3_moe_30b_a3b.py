"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4)
vocab=151936, MoE 128 experts top-8, expert d_ff=768."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def _full():
    return TransformerConfig(
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=0,
        vocab=151936, moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        tie_embeddings=True, compute_dtype=torch.bfloat16,
        attn_chunk=1024)


def _smoke():
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0, vocab=384,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
        compute_dtype=torch.float32, remat=False)


ARCH = ArchSpec(arch_id="qwen3-moe-30b-a3b", family="lm",
                source="hf:Qwen/Qwen3-30B-A3B",
                make_config=_full, make_smoke=_smoke, shapes=LM_SHAPES)
