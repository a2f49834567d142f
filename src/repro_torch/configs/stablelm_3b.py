"""StableLM 3B — dense MHA model.

[hf:stabilityai/stablelm-*; unverified] 32L d_model=2560 32H (kv=32)
d_ff=6912 vocab=50304.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=6912, vocab_size=50304,
    subquadratic=False,
)
