"""Data pipeline: document stream -> packed fixed-length batches (port of
``repro.data``).

Variable-length documents are packed into fixed seq_len rows with the
paper's bin-packing machinery (FFD) — inputs of different sizes, bins of
capacity seq_len.  The iterator state is checkpointable (preemption-safe).
"""

from .pipeline import PackedLMDataset, packing_efficiency

__all__ = ["PackedLMDataset", "packing_efficiency"]
