"""The repo's own AdamW and LR schedules (port of ``repro.optim``)."""
from repro_torch.optim.adam import (AdamConfig, AdamW, adam_state_from_numpy,
                                    clip_by_global_norm)
from repro_torch.optim.schedules import constant, inverse_sqrt, warmup_cosine

__all__ = ["AdamConfig", "AdamW", "adam_state_from_numpy",
           "clip_by_global_norm", "constant", "inverse_sqrt",
           "warmup_cosine"]
