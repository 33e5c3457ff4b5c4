"""The port's own copy of ``repro.configs.mamba2_2p7b`` (the port imports nothing of the
JAX package); keep the two in step.

mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2405.21060; unverified",
)
