"""Mamba-2 370M — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=1024 d_ff=0 vocab=50280,
ssm_state=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=50280, ssm_state=128, attn_period=0,
    subquadratic=True,
    notes="pure SSM: O(1)-state decode, runs long_500k",
)
