"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]  54L d_model=2560 32H (kv=32, full
MHA in the shared block) d_ff=10240 vocab=32000, ssm_state=64.

Zamba2's signature: 54 Mamba2 layers with a SINGLE shared transformer block
(full self-attention + FFN, one parameter set) invoked every 6 layers — 9
invocations reusing the same weights, each with its own KV cache.  (The HF
model alternates two shared blocks and adds per-invocation LoRA deltas; we
model the single shared block — the memory/compute shape is identical, noted
as an adaptation in DESIGN.md.)

Mamba2 dims: d_state=64, head_dim=64, expand=2 (d_inner=5120, 80 heads),
n_groups=1.  Hybrid recurrent+windowed state => RUNS long_500k (the 9 shared
KV caches are sequence-sharded; decode attention is O(seq) matvec).
"""
from repro_torch.configs.base import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,               # shared block FFN
        vocab_size=32000,
        ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128,
                   n_groups=1),
        shared_attn_every=6,
        supports_long_context=True,
        long_context_note=("Mamba2 O(1) state + 9 shared-attn KV caches "
                           "(seq-sharded): long_500k runs"),
        source="arXiv:2411.15242; hf",
    )
