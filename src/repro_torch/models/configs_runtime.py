"""Runtime (non-architecture) knobs of the serving path (port of
``repro.models.configs_runtime``).

``use_pallas`` picks the kernel route: ``True`` (the default) sends prefill
attention through ``flash_attention_heads`` and the Mamba scan through
``ssd_scan_heads`` — each launches its hand-written kernel on CUDA tensors
and runs its plain version on CPU tensors —, while ``False`` takes the
reference's non-kernel path (``_grouped_attention`` and the ``ssd_impl``
scan) on any device.  Neither kernel has a backward (nor has the
reference's), so training takes ``use_pallas=False``; the wrappers refuse
autograd.

Training reads ``remat`` (``'none' | 'full' | 'dots'``: what each
repetition of the layer pattern keeps for the backward, in
``blocks.stack_apply``) and ``grad_compression`` (``'none' | 'bf16' |
'int8'``, in ``train.train_step``).  The sharding knobs take effect on a
``DeviceMesh`` (``repro_torch.parallel``): ``fsdp`` shards the embed dim
of the parameters over the data axes (``launch.rules.rules_for``),
``zero1`` the optimizer moments (``train.make_state_shardings``), and
``seq_shard_decode`` / ``seq_shard_axes`` the KV cache's sequence dim.
``moe_mode``, ``scan_layers`` and ``kernel_resident_attn`` are read
nowhere, in the reference either; they are fields so that the two
packages' flags hold the same keys.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["RuntimeFlags"]


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"              # 'none' | 'full' | 'dots'
    use_pallas: bool = True          # True: kernels; False: plain
    ssd_impl: str = "step"           # 'step' (baseline) | 'chunked'
    kv_quant: str = "none"           # 'none' | 'int8' (halves KV capacity)
    attn_probs_dtype: str = "float32"  # 'bfloat16' halves PV-matmul traffic
    kernel_resident_attn: bool = False  # roofline: scores stay on chip
    moe_mode: str = "auto"           # 'ep' | 'tp' | 'auto'
    capacity_factor: float = 1.25
    fsdp: bool = False               # ZeRO-3 param sharding over data axes
    seq_shard_decode: bool = False   # shard KV cache sequence over 'model'
    seq_shard_axes: str = "model"    # 'model' | 'all' (long-context, B=1)
    scan_layers: bool = True
    grad_compression: str = "none"   # 'none' | 'bf16' | 'int8'
    zero1: bool = True               # shard optimizer state over data axes

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)
