"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2]  60L d_model=5120 128H
(MLA: per-head KV materialized from a 512-dim latent) routed-expert
d_ff=1536, vocab=102400, MoE 160 routed experts top-6 + 2 shared experts,
first layer dense (HF first_k_dense_replace=1, dense intermediate 12288).

MLA dims (HF config): q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim
=128, qk_rope_head_dim=64, v_head_dim=128.  The compressed KV cache
(512+64 dims/token/layer regardless of the 128 heads) is why we also run the
long_500k decode shape for this arch — flagged as a documented extra in
DESIGN.md §5: attention is mathematically full, but decode is O(seq) with a
sequence-sharded latent cache and the memory actually fits.

ZeRO/FSDP sharding + grad accumulation are on: 236B params do not fit a v5e
pod otherwise (EXPERIMENTS.md §Dry-run memory table).
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12288,               # leading dense layer (HF intermediate_size)
        vocab_size=102400,
        moe=MoECfg(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                   first_dense_layers=1),
        mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                   v_head=128),
        supports_long_context=True,
        long_context_note=("MLA compressed KV (576 dims/token/layer) makes "
                           "500k decode memory-feasible; run as documented "
                           "extra"),
        fsdp=True,
        source="arXiv:2405.04434; hf",
    )
