"""Llama-4 Maverick 400B-A17B — 128-expert top-1 MoE, alternating dense/MoE.

[hf:meta-llama/Llama-4-*; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 on every other layer (early fusion).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_period=2,
    rope_theta=5e5,
    subquadratic=False,
    notes="MoE on every 2nd layer (interleaved dense/MoE)",
)
