"""AdamW configuration, as ``repro.optim.adam.AdamConfig`` declares it.

Only the declarative config is ported so far: ``EngineConfig.optim`` must
load from the reference's JSON.  The AdamW update comes with the training
port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-3                 # paper §4.1: ADAM, lr 0.003
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    moment_dtype: Any = torch.float32  # torch.bfloat16 halves moment memory
