"""Architecture configuration + registry.

One ``ArchConfig`` per assigned architecture
(src/repro_torch/configs/<id>.py) with the exact published dimensions;
``reduced()`` derives the CPU smoke-test variant (same family/pattern, tiny
dims).  A copy of ``repro.configs`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "register", "get_config", "list_archs", "SHAPES"]


# assigned input-shape grid (LM family): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1          # MoE FFN every `moe_period`-th layer
    # attention pattern
    window: int = 0              # sliding window for 'window' layers
    local_global_period: int = 0  # N -> every Nth layer full, rest windowed
    # SSM / hybrid
    ssm_state: int = 0
    attn_period: int = 0         # N -> layer i%N==0 is attention, rest mamba
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0
    # modality frontend (stub: precomputed embeddings)
    frontend: str = "none"       # none|audio|vision
    num_frontend_tokens: int = 0
    mlp_variant: str = "swiglu"  # 'swiglu' (3 mats) | 'gelu' (2 mats)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    subquadratic: bool = False   # eligible for long_500k
    notes: str = ""

    # ------------------------------------------------------------- derived
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def padded_vocab(self, multiple: int = 512) -> int:
        """Vocab rounded up so the embedding shards evenly over any TP axis
        up to `multiple` (MaxText-style padding; extra logits are never
        targets)."""
        return -(-self.vocab_size // multiple) * multiple

    def mamba_meta(self) -> dict:
        d_inner = 2 * self.d_model
        p = 64
        return {"d_inner": d_inner, "H": d_inner // p,
                "N": self.ssm_state, "P": p}

    def layer_kinds(self) -> list[dict]:
        """Per-layer {'mixer','window','ffn','cross'} honoring the periods."""
        out = []
        for i in range(self.num_layers):
            mixer = "attn"
            if self.ssm_state and (self.attn_period == 0
                                   or i % self.attn_period != 0):
                mixer = "mamba"
            win = self.window
            if self.local_global_period:
                # every Nth layer is global, the rest sliding-window
                win = 0 if (i % self.local_global_period ==
                            self.local_global_period - 1) else self.window
            ffn = "none" if self.d_ff == 0 else "dense"
            if self.num_experts and (i % self.moe_period ==
                                     self.moe_period - 1):
                ffn = "moe"
            out.append({"mixer": mixer, "window": win, "ffn": ffn,
                        "cross": self.encoder_layers > 0})
        return out

    # --------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Total parameters (embeddings counted once — tied)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim_()
        total = V * d
        for kind in self.layer_kinds():
            if kind["mixer"] == "attn":
                total += d * (H + 2 * Hkv) * D + H * D * d
            else:
                m = self.mamba_meta()
                di, N, Hm = m["d_inner"], m["N"], m["H"]
                total += d * (2 * di + 2 * N + Hm) + 4 * (di + 2 * N) \
                    + di * d + 3 * Hm + di
            if kind["cross"]:
                total += d * (H + 2 * Hkv) * D + H * D * d
            nmats = 2 if self.mlp_variant == "gelu" else 3
            if kind["ffn"] == "dense":
                total += nmats * d * ff
            elif kind["ffn"] == "moe":
                total += d * self.num_experts \
                    + nmats * d * ff * self.num_experts
        if self.encoder_layers:
            total += self.encoder_layers * (
                d * (H + 2 * Hkv) * D + H * D * d
                + (2 if self.mlp_variant == "gelu" else 3) * d * ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_equiv = dataclasses.replace(self, num_experts=0)
        inactive = 0
        nmats = 2 if self.mlp_variant == "gelu" else 3
        for kind in self.layer_kinds():
            if kind["ffn"] == "moe":
                inactive += nmats * d * ff * (self.num_experts
                                              - self.experts_per_token)
                inactive -= d * self.num_experts  # router is extra, keep
        return self.param_count() - inactive

    # -------------------------------------------------------------- reduced
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = max(1, self.attn_period, self.local_global_period,
                  self.moe_period if self.num_experts else 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2 * pat, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            window=min(self.window, 8) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else 0,
            num_frontend_tokens=8 if self.num_frontend_tokens else 0,
        )


_REGISTRY: dict[str, str] = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "granite-34b": "repro_torch.configs.granite_34b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
}


def register(name: str, module: str) -> None:
    _REGISTRY[name] = module


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    mod = importlib.import_module(_REGISTRY[name])
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_REGISTRY)
