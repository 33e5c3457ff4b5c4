"""The port's own copy of ``repro.configs.base`` (the port imports nothing of the
JAX package); keep the two in step.

Config system: model + shape configs for every assigned architecture.

Every architecture in the assignment pool is expressed as a `ModelConfig`.
`ShapeConfig` describes the (seq_len, global_batch) cells each arch is paired
with.  `reduced()` produces a tiny same-family config for CPU smoke tests;
the FULL configs are only ever lowered abstractly (dry-run), never allocated.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Shape cells (assignment: LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention details ---
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: int = 0     # 0 = no local attention anywhere
    global_every: int = 0       # >0: layer i is GLOBAL iff (i+1) % global_every == 0
                                # (gemma3 5:1 local:global -> global_every=6)
    mlp_type: str = "swiglu"    # swiglu | geglu | gelu
    norm_eps: float = 1e-5

    # --- mixture of experts ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # per-expert hidden dim (defaults to d_ff)
    moe_every: int = 1          # layer i is MoE iff i % moe_every == (moe_every-1)

    # --- state-space (mamba2 SSD) ---
    ssm_state: int = 0          # d_state; >0 enables SSM layers
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128        # SSD chunk length
    attn_period: int = 0        # hybrid: one attention layer per `attn_period`
                                # layers (jamba 1:7 -> attn_period=8); 0 = pure

    # --- multimodal frontends (STUBS per assignment) ---
    cross_attn_period: int = 0  # vlm: every k-th layer cross-attends to patches
    n_image_tokens: int = 0
    embed_input: bool = False   # audio: inputs are precomputed frame embeddings

    # --- numerics ---
    param_dtype: str = "float32"   # master params
    compute_dtype: str = "bfloat16"

    # populated by configs/: human-readable provenance
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts > 0 and self.d_expert == 0:
            object.__setattr__(self, "d_expert", self.d_ff)

    # --- derived dims -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid schedule: jamba puts 1 attention layer per `attn_period`."""
        if self.ssm_state == 0:
            return True
        if self.attn_period == 0:
            return False              # pure SSM
        # place the attention layer in the middle of each period (jamba: idx 4 of 8)
        return i % self.attn_period == self.attn_period // 2

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return i % self.moe_every == self.moe_every - 1

    def is_global_attn_layer(self, i: int) -> bool:
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (i + 1) % self.global_every == 0

    def is_cross_attn_layer(self, i: int) -> bool:
        if self.cross_attn_period == 0:
            return False
        return (i + 1) % self.cross_attn_period == 0

    # --- parameter counting (for roofline MODEL_FLOPS) -----------------
    def _attn_params(self) -> int:
        qn = 2 * self.head_dim if self.qk_norm else 0
        return (self.d_model * self.q_dim            # Wq
                + 2 * self.d_model * self.kv_dim     # Wk, Wv
                + self.q_dim * self.d_model          # Wo
                + qn)

    def _mlp_params(self, hidden: int) -> int:
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        return mult * self.d_model * hidden

    def _ssm_params(self) -> int:
        di, ds, nh = self.ssm_inner, self.ssm_state, self.ssm_heads
        # in_proj -> [x (di), z (di), B (ds), C (ds), dt (nh)]; out_proj di->d
        return (self.d_model * (2 * di + 2 * ds + nh)
                + di * self.d_model
                + 4 * (di + 2 * ds)                  # depthwise conv (width 4)
                + 3 * nh                             # A_log, D, dt_bias
                + di)                                # gated norm

    def _layer_params(self, i: int) -> int:
        p = 2 * self.d_model                         # two RMSNorms
        if self.ssm_state > 0 and not self.is_attn_layer(i):
            p += self._ssm_params()
        else:
            # cross-attn layers REPLACE self-attn (mllama-style) + tanh gate
            p += self._attn_params()
            if self.is_cross_attn_layer(i):
                p += 1
        if self.ssm_state > 0 and self.is_attn_layer(i) is False and self.family == "ssm":
            return p                                 # pure mamba2: no MLP
        if self.is_moe_layer(i):
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            p += self.n_experts * mult * self.d_model * self.d_expert
            p += self.n_shared_experts * mult * self.d_model * self.d_expert
            p += self.d_model * self.n_experts       # router
        else:
            p += self._mlp_params(self.d_ff)
        return p

    def _layer_active_params(self, i: int) -> int:
        p = self._layer_params(i)
        if self.is_moe_layer(i):
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            inactive = (self.n_experts - self.top_k) * mult * self.d_model * self.d_expert
            p -= inactive
        return p

    def count_params(self) -> int:
        emb = self.vocab_size * self.d_model * 2     # embed + untied lm head
        body = sum(self._layer_params(i) for i in range(self.n_layers))
        return emb + body + self.d_model             # final norm

    def count_active_params(self) -> int:
        emb = self.vocab_size * self.d_model * 2
        body = sum(self._layer_active_params(i) for i in range(self.n_layers))
        return emb + body + self.d_model

    # --- shape applicability -------------------------------------------
    def supports_shape(self, shape: ShapeConfig) -> bool:
        """long_500k only for sub-quadratic archs (SSM / hybrid)."""
        if shape.name == "long_500k":
            return self.family in ("ssm", "hybrid")
        return True

    # --- smoke-test reduction -------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: keeps every structural pattern (MoE period,
        hybrid period, local:global mix, cross-attn period) at minimum size."""
        n_layers = 2
        if self.attn_period:
            n_layers = self.attn_period              # one full hybrid period
        if self.global_every:
            n_layers = self.global_every             # one local:global period
        if self.cross_attn_period:
            n_layers = self.cross_attn_period        # one cross-attn period
        if self.n_experts and self.moe_every > 1:
            n_layers = max(n_layers, 2 * self.moe_every)
        head_dim = 16
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, round(n_heads * self.n_kv_heads / max(self.n_heads, 1)))
        while n_heads % n_kv:
            n_kv -= 1
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=96,
            d_expert=48 if self.n_experts else 0,
            vocab_size=128,
            n_experts=min(4, self.n_experts) if self.n_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            n_shared_experts=min(1, self.n_shared_experts),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            sliding_window=8 if self.sliding_window else 0,
            n_image_tokens=8 if self.n_image_tokens else 0,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "musicgen-medium",
    "llama-3.2-vision-90b",
    "phi3-mini-3.8b",
    "qwen3-8b",
    "gemma3-4b",
    "yi-34b",
    "dbrx-132b",
    "deepseek-moe-16b",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
]

_MODULE_FOR_ARCH = {
    "musicgen-medium": "musicgen_medium",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen3-8b": "qwen3_8b",
    "gemma3-4b": "gemma3_4b",
    "yi-34b": "yi_34b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-2.7b": "mamba2_2p7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "siren": "siren",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(arch: str) -> list[ShapeConfig]:
    """The assigned (arch x shape) cells, honoring long_500k applicability."""
    cfg = get_config(arch)
    return [s for s in SHAPES.values() if cfg.supports_shape(s)]
