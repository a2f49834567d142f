"""StableLM-2 1.6B — small dense MHA model.

[hf:stabilityai/stablelm-2-1_6b; unverified] 24L d_model=2048 32H (kv=32)
d_ff=5632 vocab=100352.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=5632, vocab_size=100352,
    subquadratic=False,
)
