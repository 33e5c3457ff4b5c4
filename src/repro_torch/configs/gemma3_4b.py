"""The port's own copy of ``repro.configs.gemma3_4b`` (the port imports nothing of the
JAX package); keep the two in step.

gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local:global attention (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    rope_theta=1e6,
    qk_norm=True,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    mlp_type="geglu",
    source="hf:google/gemma-3-1b-pt; unverified",
)
