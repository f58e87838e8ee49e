"""starcoder2-7b — dense code LM, GQA + RoPE, non-gated GELU FFN.

[arXiv:2402.19173; hf bigcode/starcoder2-7b]  32L d_model=4608 36H
(GQA kv=4) d_ff=18432 (= 4x) vocab=49152.  starcoder2 uses a plain GELU MLP
(not gated), LayerNorm-family norms, learned biases on projections, and
rope_theta=1e5 for the 16k context.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        attn_bias=True,
        ffn_act="gelu_tanh",
        gated_ffn=False,
        rope_theta=1e5,
        supports_long_context=False,
        long_context_note="pure full-attention arch: 500k decode skipped",
        source="arXiv:2402.19173; hf",
    )
