"""The LM stack of the port (``repro.models``): serving path.

``build_model`` / :class:`LMModel` (decoder-only; prefill, KV/SSM cache
decode), :class:`RuntimeFlags`, and :func:`load_reference_params` to carry
the JAX package's weights across.  Layers, Mamba, MoE and blocks are eager
PyTorch; prefill attention and the Mamba scan go through the hand-written
kernels on the kernel route.
"""

from .configs_runtime import RuntimeFlags
from .lm import LMModel, build_model, load_reference_params

__all__ = ["LMModel", "build_model", "load_reference_params", "RuntimeFlags"]
