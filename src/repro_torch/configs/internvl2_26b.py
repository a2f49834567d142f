"""InternVL2-26B — InternViT frontend STUB + InternLM2 backbone.

[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553; input_specs supplies 256 precomputed patch embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92553,
    frontend="vision", num_frontend_tokens=256,
    subquadratic=False,
    notes="vision tokens prepended to the text sequence",
)
