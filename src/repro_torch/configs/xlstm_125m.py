"""xlstm-125m — xLSTM language model (mLSTM + sLSTM blocks).

[arXiv:2405.04517; unverified]  12L d_model=768 4H d_ff=0 vocab=50304.

The xLSTM paper's 125M models use an mLSTM:sLSTM block ratio of 7:1
("xLSTM[7:1]"); with 12 blocks we place sLSTM at indices (3, 9) and mLSTM
elsewhere (source tier is 'unverified' — the ratio, dims and head count are
the published numbers, the exact placement is our choice, recorded here).
d_ff=0: xLSTM blocks have no separate FFN — the mLSTM up-projection
(proj_factor 2.0) plays that role.

O(1) recurrent decode state (matrix memory C, normalizer n, stabilizer m)
=> this arch RUNS the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig, XLSTMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        xlstm=XLSTMCfg(slstm_at=(3, 9), num_heads=4, proj_factor=2.0,
                       qk_factor=0.5),
        tie_embeddings=True,
        supports_long_context=True,
        long_context_note="O(1) recurrent state: long_500k runs",
        source="arXiv:2405.04517; unverified",
    )
