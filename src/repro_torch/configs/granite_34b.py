"""Granite 34B code model — deep-narrow llama arch with MQA (kv=1).

[arXiv:2405.04324; hf] 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    head_dim=128, d_ff=24576, vocab_size=49152,
    mlp_variant="gelu",
    subquadratic=False,
    notes="MQA: single KV head is replicated across the TP axis",
)
