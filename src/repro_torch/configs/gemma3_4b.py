"""Gemma-3 4B — 5:1 local:global attention, 128k context, huge vocab.

[hf:google/gemma-3-*; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144; sliding window 1024 on local layers.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    head_dim=256, d_ff=10240, vocab_size=262144,
    window=1024, local_global_period=6, rope_theta=1e6,
    subquadratic=True,   # 5/6 of layers are 1k-window
    notes="5 local (w=1024) : 1 global repeating; 34 = 5 blocks + 4 tail",
)
