"""The port's own copy of ``repro.configs.deepseek_moe_16b`` (the port imports nothing of the
JAX package); keep the two in step.

deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400,
MoE 2 shared + 64 routed top-6, fine-grained experts. [arXiv:2401.06066; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    source="arXiv:2401.06066; hf",
)
