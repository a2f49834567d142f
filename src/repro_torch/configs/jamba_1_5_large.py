"""Jamba-1.5 Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16 experts top-2 on every other layer; attention on layer i%8==0.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_period=2,
    ssm_state=128, attn_period=8,
    subquadratic=True,
    notes="1 attention : 7 mamba per 8-layer block; MoE every 2nd FFN",
)
