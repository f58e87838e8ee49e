"""Unified architecture config + assigned input shapes.

One frozen dataclass covers all 10 assigned LM-family architectures; family-
specific sub-configs (MoE / MLA / SSM / xLSTM) are optional fields.  Every
arch file instantiates the exact published numbers; ``reduced()`` produces
the same *family* at smoke-test scale (small dims, same block pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int                  # routed expert hidden dim
    num_shared: int = 0            # always-on shared experts (deepseek: 2)
    dense_residual: bool = False   # dense FFN in parallel with MoE (arctic)
    first_dense_layers: int = 0    # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_at: Tuple[int, ...] = ()   # layer indices running sLSTM blocks
    num_heads: int = 4
    proj_factor: float = 2.0         # mLSTM up-projection
    qk_factor: float = 0.5           # qk dim = qk_factor * d_inner
    conv_kernel: int = 4
    chunk: int = 0                   # 0 = parallel [S,S] form (paper);
                                     # >0 = chunkwise kernel form (§Perf)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads
    attn_bias: bool = False           # qwen2 QKV bias
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    ffn_act: str = "silu"             # gate activation (silu=SwiGLU, gelu=GeGLU)
    gated_ffn: bool = True
    norm_type: str = "rmsnorm"
    tie_embeddings: bool = False
    scale_embed: bool = False         # gemma: h0 = embed * sqrt(d_model)
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    shared_attn_every: int = 0        # zamba2: shared attn block cadence
    encoder_layers: int = 0           # >0 -> encoder-decoder
    frontend: Optional[str] = None    # audio | vision (STUB embeddings)
    frontend_tokens: int = 256        # vision tokens prepended (vlm)
    supports_long_context: bool = False
    long_context_note: str = ""
    dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "reference"      # reference | pallas
    fsdp: bool = False                # ZeRO-style param/opt sharding over DP
    grad_accum: int = 1               # microbatch accumulation in train_step
    chunked_ce: int = 0               # 0 = plain CE; >0 = fused block-wise
                                      # unembed+CE, never materializes
                                      # [B,S,V] logits (§Perf)
    bf16_grad_stream: bool = False    # grad_cast at block boundaries: pin
                                      # backward residual cotangents to the
                                      # forward dtype (§Perf deepseek it. 2)
    pure_dp: bool = False             # batch over ALL mesh axes + ZeRO-3
                                      # param sharding, no TP — the right
                                      # regime for <=7B dense archs (§Perf);
                                      # not valid for MoE (experts need the
                                      # model axis)
    source: str = ""                  # provenance tag

    @property
    def head_dim_eff(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: tiny dims, same family/block pattern."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            frontend_tokens=8 if self.frontend else self.frontend_tokens,
            encoder_layers=min(self.encoder_layers, 2),
            remat=False,
            dtype="float32",
            fsdp=False,
            grad_accum=1,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_expert=32,
                num_shared=min(self.moe.num_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.mla:
            changes["mla"] = MLACfg(q_lora=32, kv_lora=16, qk_nope=16,
                                    qk_rope=8, v_head=16)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.xlstm:
            changes["xlstm"] = dataclasses.replace(
                self.xlstm, slstm_at=tuple(i for i in self.xlstm.slstm_at
                                           if i < changes["num_layers"]) or (1,),
                num_heads=2)
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Assigned input shapes (identical set for every LM arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str             # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (cfg.long_context_note or
                       "pure full-attention arch: 500k decode skipped")
    return True, ""


def smoke_shape(kind: str) -> ShapeSpec:
    """Tiny shape for CPU smoke tests."""
    if kind == "train":
        return ShapeSpec("smoke_train", 32, 2, "train")
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", 32, 1, "prefill")
    return ShapeSpec("smoke_decode", 32, 2, "decode")
