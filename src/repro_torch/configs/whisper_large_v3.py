"""Whisper large-v3 — encoder-decoder; conv audio frontend is a STUB
(input_specs supplies precomputed frame embeddings (B, 1500, d)).

[arXiv:2212.04356; unverified] 32L d_model=1280 20H d_ff=5120 vocab=51866.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    head_dim=64, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_seq=1500, frontend="audio",
    mlp_variant="gelu",
    subquadratic=False,
    notes="enc-dec; RoPE substituted for learned positions (documented)",
)
