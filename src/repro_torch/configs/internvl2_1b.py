"""internvl2-1b — VLM: InternViT frontend (STUB) + Qwen2-0.5B LM backbone.

[arXiv:2404.16821; hf OpenGVLab/InternVL2-1B]  24L d_model=896 14H
(GQA kv=2) d_ff=4864 vocab=151655.

Backbone only: the InternViT-300M patch embedder is a STUB — ``input_specs()``
provides precomputed patch embeddings [B, 256, d_model] prepended to the text
sequence.  The LM is the Qwen2 family: QKV bias, GQA kv=2, SwiGLU,
rope_theta=1e6 (qwen2-0.5b HF config).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        attn_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,      # qwen2-0.5b ties embeddings
        frontend="vision",
        frontend_tokens=256,
        supports_long_context=False,
        long_context_note="pure full-attention arch: 500k decode skipped",
        source="arXiv:2404.16821; hf",
    )
