"""qwen2-7b — dense decoder, GQA with QKV bias.

[arXiv:2407.10671; hf Qwen/Qwen2-7B]  28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, QKV bias (the qwen signature), rope_theta=1e6,
SwiGLU + RMSNorm.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        attn_bias=True,
        rope_theta=1e6,
        supports_long_context=False,
        long_context_note="pure full-attention arch: 500k decode skipped",
        source="arXiv:2407.10671; hf",
    )
