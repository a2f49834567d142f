"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2, moe_period=1,
    window=4096, rope_theta=1e6,
    subquadratic=True,    # SWA: decode touches a 4096-token window
    notes="SWA every layer; MoE every layer",
)
