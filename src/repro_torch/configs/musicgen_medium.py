"""The port's own copy of ``repro.configs.musicgen_medium`` (the port imports nothing of the
JAX package); keep the two in step.

musicgen-medium [audio]: decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048.
Modality frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model); labels are EnCodec token ids.
[arXiv:2306.05284; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    embed_input=True,
    source="arXiv:2306.05284; hf",
)
