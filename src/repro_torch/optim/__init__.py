"""The repo's own AdamW (port of ``repro.optim.adam``)."""
from repro_torch.optim.adam import (AdamConfig, AdamW, adam_state_from_numpy,
                                    clip_by_global_norm)

__all__ = ["AdamConfig", "AdamW", "adam_state_from_numpy",
           "clip_by_global_norm"]
