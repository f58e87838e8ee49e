"""h2o-danube-3-4b — dense decoder, llama+mistral mix with sliding-window attn.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.  The danube recipe mixes llama (SwiGLU, RMSNorm, RoPE) with
mistral components — per the assignment the sliding-window attention is kept
(window 4096, the mistral default; source tier 'unverified', choice recorded).

head_dim = 3840/32 = 120 — NOT a multiple of 128; the roofline analysis flags
the resulting MXU padding (EXPERIMENTS.md §Roofline).

SWA => decode keeps a ring-buffer KV of window size, so memory is O(window)
not O(seq): this arch RUNS the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=1e5,
        supports_long_context=True,
        long_context_note="SWA ring-buffer KV (window 4096): long_500k runs",
        source="arXiv:2401.16818; unverified",
    )
