"""The port's own copy of ``repro.configs.jamba_v01_52b`` (the port imports nothing of the
JAX package); keep the two in step.

jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    d_expert=14336,
    moe_every=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_period=8,            # 1 attn : 7 mamba
    source="arXiv:2403.19887; hf",
)
