"""arctic-480b — dense-MoE hybrid: 128-expert top-2 MoE + dense residual.

[hf Snowflake/snowflake-arctic-base]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128 experts top-2, with a dense transformer
residual in parallel with the routed experts (Arctic's "Dense-MoE hybrid").

Largest memory cell of the assignment (~482B params): requires ZeRO/FSDP
param+optimizer sharding over the DP axes on top of EP over 'model', plus
bf16 optimizer moments and grad accumulation (EXPERIMENTS.md §Dry-run).
"""
from repro_torch.configs.base import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,                # dense residual FFN dim
        vocab_size=32000,
        moe=MoECfg(num_experts=128, top_k=2, d_expert=4864,
                   dense_residual=True),
        supports_long_context=False,
        long_context_note="pure full-attention arch: 500k decode skipped",
        fsdp=True,
        source="hf:Snowflake/snowflake-arctic-base",
    )
