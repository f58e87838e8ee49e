"""gemma-2b — dense decoder, MQA, GeGLU, head_dim=256.

[arXiv:2403.08295; hf google/gemma-2b]  18L d_model=2048 8H (MQA kv=1)
d_ff=16384 vocab=256000, GeGLU activation, head_dim=256 (> d_model/H),
tied embeddings, embeddings scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        ffn_act="gelu_tanh",      # GeGLU
        gated_ffn=True,
        tie_embeddings=True,
        scale_embed=True,
        supports_long_context=False,
        long_context_note="pure full-attention arch: 500k decode skipped",
        source="arXiv:2403.08295; hf",
    )
