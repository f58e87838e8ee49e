"""seamless-m4t-medium — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf facebook/seamless-m4t-medium]  12L d_model=1024 16H
(GQA kv=16 = full MHA) d_ff=4096 vocab=256206.

Backbone only: 12 encoder + 12 decoder layers; the speech frontend
(wav2vec-BERT conformer) is a STUB — ``input_specs()`` provides precomputed
frame embeddings [B, S_enc, d_model] (DESIGN.md §5).  Encoder self-attention
is bidirectional; decoder is causal self-attn + cross-attn over the encoder
output.  The real model uses sinusoidal positions + LayerNorm; we keep the
repo-uniform RoPE/RMSNorm blocks (backbone dims are what the dry-run /
roofline exercise — noted as an adaptation).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,            # decoder layers
        encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        ffn_act="relu",           # seamless uses ReLU FFNs
        gated_ffn=False,
        frontend="audio",
        supports_long_context=False,
        long_context_note="full-attention enc-dec: 500k decode skipped",
        source="arXiv:2308.11596; hf",
    )
