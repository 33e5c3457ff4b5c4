"""The port's own copy of ``repro.configs.llama32_vision_90b`` (the port imports nothing of the
JAX package); keep the two in step.

llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers every 5th layer.

Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, n_image_tokens, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_period=5,
    n_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
