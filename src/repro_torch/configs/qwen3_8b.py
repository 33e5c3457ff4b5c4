"""The port's own copy of ``repro.configs.qwen3_8b`` (the port imports nothing of the
JAX package); keep the two in step.

qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
