"""phi4-mini-3.8b [arXiv:2412.08905; hf]: 32L d=3072 24H (GQA kv=8)
d_ff=8192 vocab=200064 — RoPE SwiGLU GQA."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def _full():
    return TransformerConfig(
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
        vocab=200064, rope_theta=10000.0, tie_embeddings=True,
        compute_dtype=torch.bfloat16)


def _smoke():
    return TransformerConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, compute_dtype=torch.float32, remat=False)


ARCH = ArchSpec(arch_id="phi4-mini-3.8b", family="lm",
                source="arXiv:2412.08905 (hf-verified)",
                make_config=_full, make_smoke=_smoke, shapes=LM_SHAPES)
