"""The LM stack of the port (``repro.models``): serving and training.

``build_model`` / :class:`LMModel` (decoder-only, encoder-decoder with
cross-attention, and the audio / vision frontend stubs; prefill, KV/SSM
cache decode, the training loss), :class:`RuntimeFlags`, and
:func:`load_reference_params` / :func:`export_reference_params` to carry
weights between the JAX package's tree and the port (``reference_ranks``
gives each parameter's rank there, which decides its weight decay).
Layers, Mamba, MoE and blocks are eager PyTorch; causal prefill attention
and the Mamba scan go through the hand-written kernels on the kernel
route (the encoder and cross-attention stay on plain attention, as in the
reference), and training takes the non-kernel route.
"""

from .configs_runtime import RuntimeFlags
from .lm import LMModel, build_model, export_reference_params, \
    load_reference_params, reference_paths, reference_ranks

__all__ = ["LMModel", "build_model", "load_reference_params",
           "export_reference_params", "reference_paths", "reference_ranks",
           "RuntimeFlags"]
